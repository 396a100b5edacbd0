from repro_torch.checkpoint.io import restore_pytree, save_pytree  # noqa: F401
