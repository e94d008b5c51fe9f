"""Plain PyTorch references in float32 (TF32 off). They import nothing of
the program (``repro_torch``) and nothing of JAX or the JAX package."""
