"""The plain reference: a dense decoder and its AdamW in plain
PyTorch, float32 with TF32 off, from the configuration file's numbers.
It imports nothing of the program and nothing of JAX."""
