"""The LM/MoE stack, ported for serving: layers, the MoE FFN with GAIA
placement, GQA and MLA attention, transformer blocks and zamba2's shared
block, the recurrent RWKV6 and Mamba2 layers, the LM and the carrying
of weights and state from the reference (`convert`)."""
