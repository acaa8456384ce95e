from .npz import (
    all_steps,
    latest_step,
    load_arrays,
    load_pytree,
    restore,
    save_arrays,
    save_pytree,
    update_json,
)

__all__ = ["save_pytree", "load_pytree", "restore", "latest_step", "all_steps",
           "save_arrays", "load_arrays", "update_json"]
