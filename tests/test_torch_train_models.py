"""The port's LM gradients against the reference's on the CPU, for all
ten architectures' smoke configs in float32.

``lm.loss_and_grads`` (autograd through the port's model, each layer
rematerialised as the smoke configs' ``remat`` asks) against
``jax.value_and_grad`` of the reference's ``lm_loss`` on the same
weights (``params_from_reference``) and inputs (tokens, plus frames or
patches where the family takes them): the loss within 1e-5 relative,
the metrics equal, and every reference leaf's gradient (the port's
per-layer gradients stacked as the reference stacks its leaf) within
1e-4 of that leaf's max |g|.
"""
from __future__ import annotations

import jax
import numpy as np
import pytest
import torch

from _torch_lm_common import (FWD, _batch, _inputs, _reference_params,
                              assert_grads_match, grad_tree)
from repro.configs import ARCH_IDS
from repro.configs import get_config as ref_config
from repro.models import lm as ref_lm
from repro.models import transformer as ref_tf
from repro_torch.configs import get_config
from repro_torch.interop import _flatten, params_from_reference
from repro_torch.models import lm

torch.set_num_threads(1)

LOSS_RTOL = 1e-5


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_gradients_match_reference(arch):
    rcfg, cfg = ref_config(arch, smoke=True), get_config(arch, smoke=True)
    params, params_np = _reference_params(rcfg)
    model = params_from_reference(params_np, cfg, "cpu")
    x = _inputs(cfg, seed=3)
    (want, wm), wg = jax.jit(jax.value_and_grad(
        lambda p, b: ref_lm.lm_loss(p, b, rcfg, ref_tf.ActSpecs()),
        has_aux=True))(params, _batch(x, FWD, False))
    got, gm, grads = lm.loss_and_grads(model, _batch(x, FWD, True), cfg)
    np.testing.assert_allclose(float(got), float(want), rtol=LOSS_RTOL)
    np.testing.assert_allclose(float(gm["nll"]), float(wm["nll"]),
                               rtol=LOSS_RTOL)
    np.testing.assert_allclose(float(gm["aux"]), float(wm["aux"]),
                               rtol=LOSS_RTOL, atol=1e-7)
    assert int(gm["tokens"]) == int(wm["tokens"])
    assert cfg.remat  # the smoke configs train rematerialised
    assert_grads_match(grad_tree(model, cfg, grads),
                       _flatten(jax.tree.map(np.asarray, wg)))
    # the call leaves the weights as it found them
    assert not any(p.requires_grad for p in model.parameters())
