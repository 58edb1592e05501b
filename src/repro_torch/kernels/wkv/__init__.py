"""The intra-chunk term of RWKV6's chunked WKV and its backward: CUDA
kernels (`csrc/wkv_intra.cu`, `csrc/wkv_intra_bwd.cu`) and their plain
versions."""
