"""Every model family's smoke config in fp16 (parameters and compute)
against the JAX reference, on the CPU.

The forward from the bridged reference init (LoRA B factors made
non-zero), logits and the LoRA projection held within four fp16 ulps of
their largest magnitude (2^-8 relative), the bound of
``tests/test_torch_fp16.py``'s GPT-2 model: each op rounds to fp16, but not
at the same places in the two frameworks.  The VLM and audio configs take
the reference's stub frontend draw (``_torch_modal``), the MoE ones a
capacity factor of 8 (no token dropped, as ``tests/test_torch_families.py``:
routing is not what is held here).
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
from _torch_modal import reference_frontend  # noqa: E402,F401
from _torch_threads import one_torch_thread  # noqa: E402,F401
from test_torch_fp16 import _LORA, MODEL_TOL, _jax_params, _tokens, _within  # noqa: E402

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_smoke_config as j_smoke  # noqa: E402
from repro.configs.base import LoRAConfig as JLoRA  # noqa: E402
from repro.models import forward as j_forward  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.configs import ARCHITECTURES, get_smoke_config  # noqa: E402
from repro_torch.configs.base import LoRAConfig as TLoRA  # noqa: E402
from repro_torch.models import forward as t_forward  # noqa: E402


@pytest.mark.parametrize("arch", list(ARCHITECTURES))
def test_every_family_forward_in_fp16_matches_reference(arch):
    over = dict(param_dtype="float16", compute_dtype="float16")
    if j_smoke(arch).moe is not None:  # no token dropped: routing is not what is held here
        over["moe"] = dataclasses.replace(j_smoke(arch).moe, capacity_factor=8.0)
    jc = j_smoke(arch).with_overrides(lora=JLoRA(**_LORA), **over)
    tc = get_smoke_config(arch).with_overrides(lora=TLoRA(**_LORA), **over)
    jp = _jax_params(jc, 11)
    tp = bridge.to_torch(jax.tree.map(np.asarray, jp), "cpu")
    assert all(v.dtype == torch.float16 for v in tp.values() if v.is_floating_point())
    tok = _tokens(12, (2, 10), jc.vocab_size)
    j_logits, j_aux = j_forward(jp, jc, {"tokens": jnp.asarray(tok)})
    t_logits, t_aux = t_forward(tp, tc, torch.as_tensor(tok)[None])
    assert t_logits.dtype == torch.float16 and bool(torch.isfinite(t_logits).all())
    _within(t_logits[0], j_logits, MODEL_TOL)
    _within(t_aux.lora_h[0], j_aux.lora_h, MODEL_TOL)
