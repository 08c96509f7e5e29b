"""A mixed fleet of a dense, an SSM and a hybrid family through the port's
engines, against the JAX reference, on the CPU.

The families are the reference's own mixed-fleet configs of
``tests/test_hetero.py`` (``H_DENSE``: a 2-layer GPT-2 at d 64; ``H_SSM``:
mamba2's smoke at d 64, state 16, heads of 16, chunk 4) and jamba's smoke
re-based onto their vocabulary (256) and LoRA (``FLORA``: rank 4 on q, v
and the head): a period of four layers (SSM, SSM + MoE, attention, SSM +
MoE) at d 256.  The server is ``H_SERVER``.  6 clients cycle the three
families, cohorts of 3, the constrained channel of ``tests/test_hetero.py``
so k varies by client.  The SSM clients' eq. 8 projection comes from
their head adapter; the hybrid's from its attention layer's q adapter.
Both packages start from the reference's init, bridged.

* The reference runs ``fused_e2e`` once (its own ``tests/test_hetero.py``
  holds its sequential engine to it).  The port's ``fused_e2e``, ``fused``,
  ``batched`` and ``sequential`` give its per-client k, uplink and
  downlink bytes and transmitters exactly, and its accuracies within one
  eval sample (1/64), the tolerance of ``tests/test_torch_hetero.py``;
  the e2e server-distill loss within rtol 1e-4.
* The port's int8 wire gives the same integers on ``fused_e2e`` and
  ``fused``.
* ``scan_rounds`` on a mixed fleet with a family in fp16 raises, naming
  its ROADMAP.md port queue item (the block itself runs:
  ``tests/test_torch_hetero_block*.py``).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
from _torch_threads import one_torch_thread  # noqa: E402,F401

import jax  # noqa: E402

from repro.configs import get_smoke_config as j_smoke  # noqa: E402
from repro.configs.base import LoRAConfig as JLoRA  # noqa: E402
from repro.configs.base import SSMConfig as JSSM  # noqa: E402
from repro.configs.gpt2_paper import REDUCED_CLIENT as J_RC  # noqa: E402
from repro.configs.gpt2_paper import REDUCED_SERVER as J_RS  # noqa: E402
from repro.core import ChannelConfig as JChannel  # noqa: E402
from repro.data import make_banking77_like as j_dataset  # noqa: E402
from repro.fed import FedConfig as JFed  # noqa: E402
from repro.fed import run_federated as j_run  # noqa: E402
from repro.models import init as j_init  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.configs import get_smoke_config as t_smoke  # noqa: E402
from repro_torch.configs.base import LoRAConfig as TLoRA  # noqa: E402
from repro_torch.configs.base import SSMConfig as TSSM  # noqa: E402
from repro_torch.configs.gpt2_paper import REDUCED_CLIENT as T_RC  # noqa: E402
from repro_torch.configs.gpt2_paper import REDUCED_SERVER as T_RS  # noqa: E402
from repro_torch.core import ChannelConfig as TChannel  # noqa: E402
from repro_torch.data import make_banking77_like as t_dataset  # noqa: E402
from repro_torch.fed import FedConfig as TFed  # noqa: E402
from repro_torch.fed import run_federated as t_run  # noqa: E402
from repro_torch.models import model as t_model  # noqa: E402

_FLORA = dict(rank=4, alpha=32.0, dropout=0.0, targets=("q", "v", "head"))


def _families(smoke, rc, rs, lora_cls, ssm_cls):
    lora = lora_cls(**_FLORA)
    dense = rc.with_overrides(name="h-dense", num_layers=2, d_model=64, num_heads=2,
                              num_kv_heads=2, d_ff=128, vocab_size=256, max_seq_len=32, lora=lora)
    ssm = smoke("mamba2-130m").with_overrides(
        name="h-ssm", d_model=64, vocab_size=256, max_seq_len=32, lora=lora,
        ssm=ssm_cls(state_dim=16, head_dim=16, expand=2, chunk_size=4))
    hybrid = smoke("jamba-1.5-large-398b").with_overrides(
        name="h-hybrid", vocab_size=256, max_seq_len=32, lora=lora)
    server = rs.with_overrides(num_layers=2, d_model=96, num_heads=2, num_kv_heads=2, d_ff=192,
                               vocab_size=256, max_seq_len=32, lora=lora)
    return [dense, ssm, hybrid], server


J_FAMS, J_SERVER = _families(j_smoke, J_RC, J_RS, JLoRA, JSSM)
T_FAMS, T_SERVER = _families(t_smoke, T_RC, T_RS, TLoRA, TSSM)
TO_JAX = dict(zip(T_FAMS + [T_SERVER], J_FAMS + [J_SERVER]))
_CHAN = dict(bandwidth_hz=2e5, mean_snr_db=2.0)
EVAL = 64


def _bridged_init(cfg, seed, device="cuda", **_):
    return bridge.to_torch(jax.tree.map(np.asarray, j_init(jax.random.PRNGKey(seed), TO_JAX[cfg])),
                           device)


def _fed(fed_cls, chan_cls, engine, **kw):
    return fed_cls(**{**dict(
        method="adald", engine=engine, num_clients=6, clients_per_round=3, rounds=2,
        public_size=64, public_batch=16, eval_size=EVAL, local_steps=2, distill_steps=1,
        server_distill_steps=2, seed=0, pretrain_steps=0, use_kernels=True,
        channel=chan_cls(**_CHAN)), **kw})


def _dataset(make):
    return make(vocab_size=256, seq_len=12, total=500, seed=0)


RUNS = {  # the port's runs: name -> (engine, FedConfig changes)
    "sequential": ("sequential", {}),
    "batched": ("batched", {}),
    "fused": ("fused", {}),
    "fused_e2e": ("fused_e2e", {}),
    "fused-int8": ("fused", dict(quantize_wire=True)),
    "fused_e2e-int8": ("fused_e2e", dict(quantize_wire=True)),
}


@pytest.fixture(scope="module")
def runs():
    out = {"reference": j_run(J_FAMS, J_SERVER, _dataset(j_dataset),
                              _fed(JFed, JChannel, "fused_e2e"))}
    mp = pytest.MonkeyPatch()
    mp.setattr(t_model, "init", _bridged_init)
    try:
        for name, (engine, change) in RUNS.items():
            out[name] = t_run(T_FAMS, T_SERVER, _dataset(t_dataset),
                              _fed(TFed, TChannel, engine, **change), device="cpu")
    finally:
        mp.undo()
    return out


def _integers(run):
    return (run.per_client_k, [(r.uplink_bytes, r.downlink_bytes, r.num_transmitters)
                               for r in run.ledger.rounds])


@pytest.mark.parametrize("name", ["sequential", "batched", "fused", "fused_e2e"])
def test_a_dense_ssm_hybrid_fleet_is_the_references(runs, name):
    ref, got = runs["reference"], runs[name]
    assert _integers(got) == _integers(ref)
    assert len({k for ks in got.per_client_k for k in ks}) > 2  # the budgets vary
    np.testing.assert_allclose(got.server_acc, ref.server_acc, rtol=0, atol=1 / EVAL + 1e-9)
    np.testing.assert_allclose(got.client_acc, ref.client_acc, rtol=0, atol=1 / EVAL + 1e-9)
    if name == "fused_e2e":
        np.testing.assert_allclose(got.distill_loss, ref.distill_loss, rtol=1e-4)


def test_the_int8_wire_agrees_across_engines(runs):
    assert _integers(runs["fused-int8"]) == _integers(runs["fused_e2e-int8"]) != _integers(
        runs["fused_e2e"])


def test_scan_rounds_on_a_mixed_fleet_still_raises():
    """A mixed fleet's block runs (``tests/test_torch_hetero_block*.py``);
    with its SSM family in a dtype the port does not take (float64) it is
    refused before any work, naming the dtypes it does take."""
    fams = [T_FAMS[0], T_FAMS[1].with_overrides(compute_dtype="float64"), T_FAMS[2]]
    with pytest.raises(ValueError, match="float32, bfloat16, float16"):
        t_run(fams, T_SERVER, _dataset(t_dataset),
              _fed(TFed, TChannel, "fused_e2e", scan_rounds=True), device="cpu")
