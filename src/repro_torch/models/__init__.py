"""The model stack's serving path for every family of the JAX package
(dense GQA, MoE, MLA, the xLSTM and RG-LRU mixers, the vlm's M-RoPE and
whisper's encoder-decoder): params, layers, blocks, moe, seqmix, model,
and the conversion from the JAX package's trees."""
