"""The model stack's serving path (dense GQA ``attn`` blocks): params,
layers, blocks, model, and the conversion from the JAX package's trees."""
