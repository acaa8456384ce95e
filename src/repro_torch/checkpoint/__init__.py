from .npz import all_steps, latest_step, load_pytree, restore, save_pytree

__all__ = ["save_pytree", "load_pytree", "restore", "latest_step", "all_steps"]
