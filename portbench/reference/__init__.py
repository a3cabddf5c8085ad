"""The plain reference that decides ``correct``: plain PyTorch, f32 with TF32
off, written from the published descriptions.  It imports neither JAX nor
the JAX package nor anything of the port, and takes from the benchmark only
the inputs (weights, prompts, batches) that it also hands to the port."""
