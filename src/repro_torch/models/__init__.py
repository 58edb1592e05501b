"""The LM/MoE stack, ported for serving: layers, the MoE FFN with GAIA
placement, GQA attention, transformer blocks, the LM and the carrying
of weights and state from the reference (`convert`)."""
