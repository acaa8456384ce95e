"""Abstract inputs, parameters and caches per (arch x shape) cell: tensors
with shapes and dtypes and no storage (the ``meta`` device), the dry
run's stand-ins.

The counterpart of ``repro/launch/specs.py``. The reference's
``ShapeDtypeStruct``s are meta tensors here; ``abstract_model`` returns
the model itself, its parameters on ``device`` (``meta`` by default; a
device under a ``FakeTensorMode`` gives fake tensors there), with the
partition specs its init declared.
"""
from __future__ import annotations

import torch

from repro_torch.configs import ModelConfig, ShapeConfig
from repro_torch.models import transformer


def input_specs(cfg: ModelConfig, shape: ShapeConfig
                ) -> dict[str, torch.Tensor]:
    """Model inputs for one step, as meta tensors: int32 tokens and
    labels, the activation dtype's ``frames``, ``enc_out`` and
    ``patches``."""
    B, S = shape.global_batch, shape.seq_len
    i32 = torch.int32
    act = torch.bfloat16 if cfg.dtype == "bfloat16" else torch.float32

    def t(shape_, dtype):
        return torch.empty(shape_, dtype=dtype, device="meta")

    if shape.mode == "train":
        batch = {"tokens": t((B, S), i32), "labels": t((B, S), i32)}
    elif shape.mode == "prefill":
        batch = {"tokens": t((B, S), i32)}
    else:  # decode: one new token against an S-long cache
        batch = {"tokens": t((B, 1), i32)}
    if cfg.family == "encdec":
        if shape.mode == "decode":
            # encoder ran at prefill; serving passes its output
            batch["enc_out"] = t((B, cfg.enc_seq, cfg.d_model), act)
        else:
            batch["frames"] = t((B, cfg.enc_seq, cfg.d_model), act)
    if cfg.family == "vlm" and shape.mode != "decode":
        batch["patches"] = t((B, cfg.stub_tokens, cfg.d_model), act)
    return batch


def abstract_model(cfg: ModelConfig, *, serve: bool = False,
                   device="meta") -> tuple[transformer.LM, dict]:
    """(the model with its parameters uninitialised on ``device``, its
    ``transformer.param_specs``). Nothing is drawn or allocated on
    ``meta``. With ``serve`` every float32 parameter is bfloat16 (the
    deployed weights)."""
    model = transformer.LM(cfg, torch.device(device))
    if serve:
        for p in model.parameters():
            if p.dtype == torch.float32:
                p.data = p.data.to(torch.bfloat16)
    return model, transformer.param_specs(model)


def abstract_caches(cfg: ModelConfig, B: int, S: int, device="meta"
                    ) -> list:
    """The decode caches of ``init_caches`` (one a decoder layer) on
    ``device``."""
    return transformer.init_caches(cfg, B, S, torch.device(device))


def param_bytes(params, bytes_per_el: int = 2) -> int:
    """``bytes_per_el`` bytes an element of every parameter: of a model,
    or of the tensors of a dict, list or tuple tree."""
    if isinstance(params, torch.nn.Module):
        leaves = list(params.parameters())
    else:
        leaves, todo = [], [params]
        while todo:
            x = todo.pop()
            if isinstance(x, dict):
                todo.extend(x.values())
            elif isinstance(x, (list, tuple)):
                todo.extend(x)
            else:
                leaves.append(x)
    return sum(int(x.numel()) * bytes_per_el for x in leaves)
