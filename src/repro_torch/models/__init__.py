"""The model stack's serving path for every decoder-only family (dense GQA,
MoE, MLA, the xLSTM and RG-LRU mixers): params, layers, blocks, moe,
seqmix, model, and the conversion from the JAX package's trees."""
