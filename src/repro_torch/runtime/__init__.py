"""The training loop: `Trainer` (data, step, checkpoints, watchdog,
crash-safe resume) and `Watchdog`, the port of `repro.runtime`."""
from repro_torch.runtime.trainer import Trainer, TrainerConfig  # noqa: F401
from repro_torch.runtime.watchdog import Watchdog  # noqa: F401
