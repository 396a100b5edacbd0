from repro_torch.checkpoint.io import (STATE_VERSION,  # noqa: F401
                                       load_state, restore_pytree,
                                       save_pytree, save_state)
