"""PyTorch port of the Sketchy optimizer stack (the JAX package
``repro`` is the reference it is held against)."""
