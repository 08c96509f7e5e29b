"""The port's fp16 federation against the JAX reference, on the CPU.

``run_federated`` with ``compute_dtype="float16"`` on the tiny configs of
``tests/test_torch_round.py`` (constrained channel, 2 rounds), the models
computing in fp16 (``ModelConfig.compute_dtype``), with ``use_kernels=True``
on both sides: ``fused_e2e`` with the float wire and ``fused`` with the
int8-coded uplink.  The port's model init is replaced by the bridged JAX
init.  (The int8 wire cut from fp16 logits is held to the reference's in
``tests/test_torch_fp16.py``: a third reference run here, ~17 s of JAX
compiles, would take the file near its 90 s.)

* Integers (per-client k, uplink and downlink bytes, transmitters) must be
  identical to the JAX fp16 run and to the port's fp32 run of the same
  engine (the budgets depend on the channel only).
* Accuracies are held at the reference's own low-precision tolerance, atol
  0.15 (``tests/test_engine.py::test_fused_e2e_bf16_round_body_parity``).
  fp16 keeps 11 significant bits against bf16's 8, but it rounds at other
  places in the two frameworks (XLA may keep a fused elementwise chain in
  fp32, PyTorch rounds after each op), Adam's normalised first steps turn
  one gradient element's rounding into a step of lr, and the low-precision
  KL of two nearly equal distributions is mostly rounding: the runs drift
  apart through training as the bf16 ones do, only less.
* The clients' budgets cover most of the 256-token vocabulary, so the
  wire teacher has no empty column here; in fp16 an empty column is
  ``0 / (0 + 1e-12)`` = NaN in both packages (1e-12 is 0 in fp16), which
  ``tests/test_torch_fp16.py`` holds bitwise.
* The path is fp16 where the reference's is: the float wire, the dense
  uplink and the aggregation's inputs reach the kernel wrappers in fp16;
  the LoRA masters and Adam moments stay fp32.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
from _torch_threads import one_torch_thread  # noqa: E402,F401

import jax  # noqa: E402

import repro.fed.rounds as j_rounds  # noqa: E402
from repro.configs.base import LoRAConfig as JLoRA  # noqa: E402
from repro.configs.gpt2_paper import REDUCED_CLIENT as J_RC  # noqa: E402
from repro.configs.gpt2_paper import REDUCED_SERVER as J_RS  # noqa: E402
from repro.core import ChannelConfig as JChannel  # noqa: E402
from repro.data import make_banking77_like as j_dataset  # noqa: E402
from repro.fed import FedConfig as JFed  # noqa: E402
from repro.models import init as j_init  # noqa: E402
import repro_torch.fed.rounds as t_rounds  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.configs.base import LoRAConfig as TLoRA  # noqa: E402
from repro_torch.configs.gpt2_paper import REDUCED_CLIENT as T_RC  # noqa: E402
from repro_torch.configs.gpt2_paper import REDUCED_SERVER as T_RS  # noqa: E402
from repro_torch.core import ChannelConfig as TChannel  # noqa: E402
from repro_torch.data import make_banking77_like as t_dataset  # noqa: E402
from repro_torch.fed import FedConfig as TFed  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.lora import split_lora  # noqa: E402
from repro_torch.models import model as t_model  # noqa: E402

ACC_TOL = 0.15  # the reference's own low-precision tolerance (tests/test_engine.py)
_LORA = dict(rank=4, alpha=32.0, dropout=0.0, targets=("q", "v", "head"))
_C = dict(num_layers=2, d_model=64, num_heads=2, num_kv_heads=2, d_ff=128, vocab_size=256,
          max_seq_len=32)
_S = dict(num_layers=2, d_model=96, num_heads=2, num_kv_heads=2, d_ff=192, vocab_size=256,
          max_seq_len=32)
J_CLIENT = J_RC.with_overrides(**_C, lora=JLoRA(**_LORA))
J_SERVER = J_RS.with_overrides(**_S, lora=JLoRA(**_LORA))
T_CLIENT = T_RC.with_overrides(**_C, lora=TLoRA(**_LORA))
T_SERVER = T_RS.with_overrides(**_S, lora=TLoRA(**_LORA))
F16 = dict(compute_dtype="float16")
J_CLIENT_H, J_SERVER_H = J_CLIENT.with_overrides(**F16), J_SERVER.with_overrides(**F16)
T_CLIENT_H, T_SERVER_H = T_CLIENT.with_overrides(**F16), T_SERVER.with_overrides(**F16)
_CHAN = dict(bandwidth_hz=2e5, mean_snr_db=2.0)
FED = dict(method="adald", num_clients=4, clients_per_round=2, public_size=64, public_batch=16,
           eval_size=64, local_steps=2, distill_steps=1, server_distill_steps=2, seed=0,
           pretrain_steps=0, rounds=2, use_kernels=True)
CASES = {  # case: (engine, quantize_wire)
    "fused_e2e-float": ("fused_e2e", False),
    "fused-int8": ("fused", True),
}
SPIED = ("scatter_wire_sums", "scatter_wire_sums_dequant", "topk_mask_dynamic", "sparse_aggregate")


def _capture(module, name, into):
    make = getattr(module, name)

    def wrapped(*args, **kwargs):
        into.append(make(*args, **kwargs))
        return into[-1]

    return wrapped


def _spy(name, seen):
    fn = getattr(ops, name)

    def wrapped(*args, **kwargs):
        seen.add((name, args[0].dtype))
        return fn(*args, **kwargs)

    return wrapped


def _t_run(client, server, fed):
    return t_rounds.run_federated(client, server,
                                  t_dataset(vocab_size=256, seq_len=12, total=500, seed=0),
                                  TFed(channel=TChannel(**_CHAN), **fed), device="cpu")


@pytest.fixture(scope="module")
def runs():
    """{case: (JAX fp16 run, port fp16 run, port fp32 run, port fp16 engine,
    its Server, {(wrapper, input dtype)} met on the fp16 run)}."""
    to_jax = {T_CLIENT_H: J_CLIENT_H, T_SERVER_H: J_SERVER_H, T_CLIENT: J_CLIENT, T_SERVER: J_SERVER}

    def bridged_init(cfg, seed, device="cuda", **_):
        tree = j_init(jax.random.PRNGKey(seed), to_jax[cfg])
        return bridge.to_torch(jax.tree.map(np.asarray, tree), device)

    out = {}
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(t_model, "init", bridged_init)
        for case, (engine, quant) in CASES.items():
            fed = dict(FED, engine=engine, quantize_wire=quant)
            j_run = j_rounds.run_federated(
                J_CLIENT_H, J_SERVER_H, j_dataset(vocab_size=256, seq_len=12, total=500, seed=0),
                JFed(channel=JChannel(**_CHAN), **fed, **F16))
            t_eng, t_srv, seen = [], [], set()
            ops.reset_launches()
            with pytest.MonkeyPatch.context() as m:
                m.setattr(t_rounds, "make_engine", _capture(t_rounds, "make_engine", t_eng))
                m.setattr(t_rounds, "Server", _capture(t_rounds, "Server", t_srv))
                for name in SPIED:
                    m.setattr(ops, name, _spy(name, seen))
                t_run = _t_run(T_CLIENT_H, T_SERVER_H, dict(fed, **F16))
            assert sum(ops.LAUNCHES.values()) == 0  # CPU tensors take the plain versions
            t_f32 = _t_run(T_CLIENT, T_SERVER, fed)
            out[case] = (j_run, t_run, t_f32, t_eng[-1], t_srv[-1], seen)
    return out


def _integers(run):
    return (run.per_client_k, [(r.uplink_bytes, r.downlink_bytes, r.num_selected,
                                r.num_transmitters) for r in run.ledger.rounds])


@pytest.mark.parametrize("case", list(CASES))
def test_fp16_round_integers_identical(runs, case):
    j_run, t_run, t_f32, *_ = runs[case]
    assert _integers(t_run) == _integers(j_run) == _integers(t_f32)
    assert len(t_run.ledger.rounds) == FED["rounds"]


@pytest.mark.parametrize("case", list(CASES))
def test_fp16_round_accuracies_within_the_reference_tolerance(runs, case):
    j_run, t_run, *_ = runs[case]
    assert np.isfinite(t_run.server_acc + t_run.client_acc).all()
    np.testing.assert_allclose(t_run.server_acc, j_run.server_acc, rtol=0, atol=ACC_TOL)
    np.testing.assert_allclose(t_run.client_acc, j_run.client_acc, rtol=0, atol=ACC_TOL)
    if CASES[case][0] == "fused_e2e":
        assert np.isfinite(t_run.distill_loss).all()
    else:  # no server-distill loss off the e2e path
        assert np.isnan(t_run.distill_loss).all() and np.isnan(j_run.distill_loss).all()


@pytest.mark.parametrize("case", list(CASES))
def test_fp16_round_keeps_fp32_masters_and_fp16_uplinks(runs, case):
    engine, _ = CASES[case]
    _, _, _, t_eng, t_srv, seen = runs[case]
    states = [t_eng._store.lora, t_eng._store.opt.m, t_eng._store.opt.v]
    if engine == "fused_e2e":
        states += [t_eng._s_lora, t_eng._s_opt.m, t_eng._s_opt.v]
        assert t_eng._b_logits.dtype == torch.float16  # the broadcast in the compute dtype
    else:
        states += [t_srv.opt.m, t_srv.opt.v, split_lora(t_srv.params)[0]]
    assert all(v.dtype == torch.float32 for tree in states for v in tree.values())
    if engine == "fused":  # the int8-coded uplink is fake-quantised in the compute dtype
        want = {("topk_mask_dynamic", torch.float16), ("sparse_aggregate", torch.float16)}
    else:
        want = {("scatter_wire_sums", torch.float16)}
    assert seen == want
