"""Data for the port, the port of `repro.data`: the synthetic token
stream (`DataConfig`, `SyntheticLM`, `make_pipeline`) and the mobility
traces of `pipeline`."""
from repro_torch.data.pipeline import (  # noqa: F401
    DataConfig, SyntheticLM, make_pipeline)
