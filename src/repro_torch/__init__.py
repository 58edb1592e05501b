"""PyTorch/CUDA port of the GAIA reproduction (`repro`), for one NVIDIA
H100.

The package mirrors `repro`'s layout: `repro_torch.core` holds the
engine and its model, `repro_torch.kernels` the CUDA kernels written by
hand for Hopper with their plain PyTorch versions, and
`repro_torch.random` a bit-exact copy of JAX's threefry generator. It
imports neither JAX nor anything of `repro`. Entry points run on the
card unless the caller passes `device="cpu"`.
"""
