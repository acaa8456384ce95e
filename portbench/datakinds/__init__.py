"""One module a data ``kind`` of a configuration's ``data``:
``features(cfg, seed, device) -> (K_true, D)`` float32 on ``device``."""
