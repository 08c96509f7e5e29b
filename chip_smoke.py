"""Smoke run of the PyTorch/CUDA port on one GPU: ``python3 chip_smoke.py``.

Phases (any failure raises and exits non-zero):

1. device — a CUDA device is required (no CPU fallback); prints the card's
   name and power limit; full-fp32 matmuls (TF32 off).
2. build — compiles every CUDA source of ``src/repro_torch/kernels/csrc``
   (one ``nvcc`` per source, all at once) into ``build/``.
3. kernels — each wire-scatter kernel against its plain PyTorch version on
   the card at the main path's widths (4 clients x 64 public samples x
   vocab 50 257, k_cap 128 and 1024; k = 0 client rows, wire padding at
   index 0 beside a real index-0 entry, negative values): ``torch.equal``.
4. small input — the port's round on a tiny config on the card (kernels)
   and on the CPU (plain versions): identical k and bytes, accuracies within
   one eval sample, server-distill loss within rtol 1e-3 and broadcast
   logits within 1e-3 of their largest magnitude (fp32 reductions run in
   another order on the card, and Adam's normalised step carries such
   differences into the weights); on the int8 wire the logits bound is one
   quantization step, 1/127, since a last-bit difference can move a value
   across a rounding boundary.
5. main path — ``run_federated`` with AdaLD, ``engine="fused_e2e"``,
   ``use_kernels=True`` at the paper's widths (GPT-2 small clients, GPT-2
   large server), float wire then int8 wire, 2 rounds each; each kernel's
   launch count must equal the rounds run.
6. timing — each kernel, its plain version and one PyTorch library call
   (``scatter_add_``) at the main path's shapes, beside the byte bound.

The last two lines are the kernels record and the device record (JSON).
"""

from __future__ import annotations

import json
import math
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))

from repro_torch.configs.base import LoRAConfig  # noqa: E402
from repro_torch.configs.gpt2_paper import GPT2_LARGE, GPT2_SMALL, REDUCED_CLIENT, REDUCED_SERVER  # noqa: E402
from repro_torch.core.aggregation import AggregationMode  # noqa: E402
from repro_torch.core.channel import ChannelConfig  # noqa: E402
from repro_torch.core.topk import quantize_wire, sparsify_wire  # noqa: E402
from repro_torch.data import make_banking77_like  # noqa: E402
from repro_torch.fed import FedConfig  # noqa: E402
from repro_torch.fed import rounds as fed_rounds  # noqa: E402
from repro_torch.fed.engines import k_cap_bucket  # noqa: E402
from repro_torch.kernels import build, ops, ref  # noqa: E402

HBM_BYTES_PER_S = 3.35e12  # H100 SXM, NVIDIA data sheet
N_CLIENTS, ROWS, VOCAB = 4, 64, GPT2_SMALL.vocab_size
MODES: tuple[AggregationMode, ...] = ("adaptive", "zeropad", "mean_nonzero")
SOURCE = "src/repro_torch/kernels/csrc/sparse_agg.cu"
REPLACES = {
    "scatter_wire_sums": "src/repro/kernels/sparse_agg.py:149",
    "scatter_wire_sums_dequant": "src/repro/kernels/sparse_agg.py:244",
}


def log(msg: str) -> None:
    print(msg, flush=True)


# -- inputs -------------------------------------------------------------------


def make_wire(k_cap: int, seed: int, device):
    """A cohort wire shaped as the main path shapes it, from sparsify_wire
    on random logits, with the edge cases forced in: client 2 sends nothing
    (k = 0), clients 1 and 3 pad their masked entries at index 0 (as
    ``pad_wire`` does) while rows of client 1 send a real index-0 entry,
    and client 3's logits are all negative."""
    gen = torch.Generator(device=device).manual_seed(seed)
    logits = torch.randn((N_CLIENTS, ROWS, VOCAB), generator=gen, device=device)
    logits[1, ::2, 0] = 10.0  # index 0 in client 1's top-k on even rows
    logits[3] -= 20.0
    ks = [k_cap, k_cap // 2, 0, 3]
    wire = sparsify_wire(logits, ks, k_cap)
    idx = torch.where(wire.mask, wire.indices, 0).contiguous()
    return wire._replace(indices=idx)


def float_channels(wire, mode: str):
    m = wire.mask.float()
    v = wire.values * m
    if mode == "adaptive":
        s = torch.abs(v)
        return s * v, s
    return v, m


# -- timing -------------------------------------------------------------------


def time_ms(fn, calls: int = 10, reps: int = 21, warmup: int = 3) -> float:
    """Milliseconds per ``fn()``: CUDA events around ``calls`` back-to-back
    calls, divided by ``calls``; the median of ``reps`` such runs.  A call
    whose host work outlasts its device work measures the host."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(calls):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / calls)
    return statistics.median(times)


def library_call(a, b, idx):
    """One ``scatter_add_`` over the client-folded wire into a (2, rows, V)
    buffer: the yardstick PyTorch offers for the same sums (timed only)."""
    n, rows, k = a.shape
    flat = (torch.arange(rows, device=a.device)[None, :, None] * VOCAB + idx.long()).reshape(-1)
    index = torch.cat([flat, flat + rows * VOCAB])
    src = torch.cat([a.reshape(-1), b.reshape(-1)])
    return lambda: torch.zeros(2 * rows * VOCAB, device=a.device).scatter_add_(0, index, src)


# -- phases -------------------------------------------------------------------


def phase_device():
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device (this script runs on the GPU only)")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True,
    ).stdout.strip().splitlines()[0]
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log(f"[device] {card}")
    log(f"[device] torch {torch.__version__} cuda {torch.version.cuda} python {sys.version.split()[0]}")
    return torch.device("cuda"), card


def phase_build():
    t0 = time.perf_counter()
    libs = build.build_all()
    log(f"[build] {', '.join(map(str, libs.values()))} in {time.perf_counter() - t0:.1f} s")


def phase_kernels(device):
    for k_cap in (128, 1024):
        wire = make_wire(k_cap, seed=k_cap, device=device)
        for mode in MODES:
            a, b = float_channels(wire, mode)
            got = ops.scatter_wire_sums(a, b, wire.indices, VOCAB)
            want = ref.scatter_wire_sums_ref(a, b, wire.indices, VOCAB)
            torch.cuda.synchronize()
            assert all(torch.equal(g, w) for g, w in zip(got, want)), ("scatter_wire_sums", k_cap, mode)
        qw = quantize_wire(wire)
        for mode in MODES:
            got = ops.scatter_wire_sums_dequant(qw.values, qw.scale, qw.mask, qw.indices, VOCAB, mode)
            want = ref.scatter_wire_sums_dequant_ref(qw.values, qw.scale, qw.mask, qw.indices, VOCAB, mode)
            torch.cuda.synchronize()
            assert all(torch.equal(g, w) for g, w in zip(got, want)), ("dequant", k_cap, mode)
        # the edge cases really are in the data
        assert not wire.mask[2].any() and bool(((wire.indices[1] == 0) & wire.mask[1]).any())
        assert bool((wire.values[3][wire.mask[3]] < 0).all())
        log(f"[kernels] k_cap={k_cap}: both kernels torch.equal to their plain versions "
            f"in all 3 modes at N={N_CLIENTS} rows={ROWS} V={VOCAB}")


def _drive(client_cfg, server_cfg, dataset, fed, device):
    """run_federated, also returning the engine it built."""
    engines = []
    make = fed_rounds.FusedE2EEngine
    fed_rounds.FusedE2EEngine = lambda *a, **k: engines.append(make(*a, **k)) or engines[-1]
    try:
        run = fed_rounds.run_federated(client_cfg, server_cfg, dataset, fed, device=device)
    finally:
        fed_rounds.FusedE2EEngine = make
    return run, engines[-1]


def phase_small_input(device):
    lora = LoRAConfig(rank=4, alpha=32.0, dropout=0.0, targets=("q", "v", "head"))
    client = REDUCED_CLIENT.with_overrides(num_layers=2, d_model=64, num_heads=2, num_kv_heads=2,
                                           d_ff=128, vocab_size=256, max_seq_len=32, lora=lora)
    server = REDUCED_SERVER.with_overrides(num_layers=2, d_model=96, num_heads=2, num_kv_heads=2,
                                           d_ff=192, vocab_size=256, max_seq_len=32, lora=lora)
    ds = make_banking77_like(vocab_size=256, seq_len=12, total=500, seed=0)
    for quant in (False, True):
        fed = FedConfig(method="adald", engine="fused_e2e", use_kernels=True, pretrain_steps=0,
                        num_clients=4, clients_per_round=2, rounds=2, public_size=64,
                        public_batch=16, eval_size=64, local_steps=2, distill_steps=1,
                        server_distill_steps=2, quantize_wire=quant,
                        channel=ChannelConfig(bandwidth_hz=2e5, mean_snr_db=2.0))
        gpu, gpu_eng = _drive(client, server, ds, fed, device)
        cpu, cpu_eng = _drive(client, server, ds, fed, "cpu")
        assert gpu.per_client_k == cpu.per_client_k
        assert [r.uplink_bytes for r in gpu.ledger.rounds] == [r.uplink_bytes for r in cpu.ledger.rounds]
        assert [r.downlink_bytes for r in gpu.ledger.rounds] == [r.downlink_bytes for r in cpu.ledger.rounds]
        np.testing.assert_allclose(gpu.server_acc, cpu.server_acc, rtol=0, atol=1 / 64 + 1e-9)
        np.testing.assert_allclose(gpu.client_acc, cpu.client_acc, rtol=0, atol=1 / 64 + 1e-9)
        np.testing.assert_allclose(gpu.distill_loss, cpu.distill_loss, rtol=1e-3)
        g_b, c_b = gpu_eng._b_logits.cpu().numpy(), cpu_eng._b_logits.numpy()
        err = float(np.abs(g_b - c_b).max() / np.abs(c_b).max())
        assert err < (1 / 127 if quant else 1e-3), err
        log(f"[small input] {'int8' if quant else 'float'} wire: card == CPU on k and bytes, "
            f"broadcast max |diff|/max|logit| = {err:.2e}, distill_loss {gpu.distill_loss} vs {cpu.distill_loss}")


def phase_main_path(device, quantize: bool):
    fed = FedConfig(method="adald", engine="fused_e2e", use_kernels=True, pretrain_steps=0,
                    num_clients=8, clients_per_round=4, rounds=2, public_batch=64,
                    local_steps=2, distill_steps=1, server_distill_steps=2, eval_size=128,
                    quantize_wire=quantize)
    ds = make_banking77_like(vocab_size=GPT2_SMALL.vocab_size, seq_len=32)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    run, engine = _drive(GPT2_SMALL, GPT2_LARGE, ds, fed, device)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    tag = "int8" if quantize else "float"
    log(f"[main path/{tag}] GPT-2 small clients x{fed.num_clients} (cohort {fed.clients_per_round}), "
        f"GPT-2 large server, {fed.rounds} rounds in {wall:.1f} s (setup included)")
    log(f"[main path/{tag}] per_client_k={run.per_client_k}")
    log(f"[main path/{tag}] uplink_bytes={[r.uplink_bytes for r in run.ledger.rounds]} "
        f"downlink_bytes={[r.downlink_bytes for r in run.ledger.rounds]}")
    log(f"[main path/{tag}] server_acc={run.server_acc} client_acc={run.client_acc} "
        f"distill_loss={run.distill_loss}")
    log(f"[main path/{tag}] round_seconds={[round(s, 3) for s in run.round_seconds]} "
        f"max_memory_allocated={torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    b = engine._b_logits
    assert tuple(b.shape) == (fed.public_batch, GPT2_LARGE.vocab_size) and bool(torch.isfinite(b).all())
    assert all(math.isfinite(x) for x in run.distill_loss + run.server_acc + run.client_acc)
    assert all(k > 0 for ks in run.per_client_k for k in ks)  # default channel: everyone transmits
    return run


def phase_timing(name: str, k_cap: int, device) -> dict:
    """``ms`` is the kernel's own time: back-to-back launches of the bound C
    entry point on preallocated outputs, so the device, not the wrapper's
    host-side checks, sets the pace; the wrapper call is timed beside it."""
    wire = make_wire(k_cap, seed=7, device=device)
    n, rows, k = wire.values.shape
    num = torch.empty((rows, VOCAB), device=device)
    den = torch.empty_like(num)
    stream = torch.cuda.current_stream(device).cuda_stream
    if name == "scatter_wire_sums":
        a, b = float_channels(wire, "adaptive")
        wrapper = lambda: ops.scatter_wire_sums(a, b, wire.indices, VOCAB)  # noqa: E731
        plain = lambda: ref.scatter_wire_sums_ref(a, b, wire.indices, VOCAB)  # noqa: E731
        fn = ops._fn("scatter_wire_sums_f32", 5, 4)
        ptrs = [t.data_ptr() for t in (a, b, wire.indices, num, den)]
        raw = lambda: fn(*ptrs, n, rows, k, VOCAB, stream)  # noqa: E731
        in_bytes = n * rows * k * (4 + 4 + 4)
    else:
        qw = quantize_wire(wire)
        a, b = ref.dequant_channels(qw.values, qw.scale, qw.mask, "adaptive")
        wrapper = lambda: ops.scatter_wire_sums_dequant(  # noqa: E731
            qw.values, qw.scale, qw.mask, qw.indices, VOCAB, "adaptive")
        plain = lambda: ref.scatter_wire_sums_dequant_ref(  # noqa: E731
            qw.values, qw.scale, qw.mask, qw.indices, VOCAB, "adaptive")
        fn = ops._fn("scatter_wire_sums_dequant_i8", 6, 5)
        ptrs = [t.data_ptr() for t in (qw.values, qw.scale, qw.mask.view(torch.uint8), qw.indices, num, den)]
        raw = lambda: fn(*ptrs, n, rows, k, VOCAB, 0, stream)  # noqa: E731  mode 0: adaptive
        in_bytes = n * rows * k * (1 + 1 + 4) + n * rows * 4
    got, want = wrapper(), plain()
    assert raw() == 0
    torch.cuda.synchronize()
    err = max(float((g - w).abs().max()) for g, w in zip(got, want))
    assert torch.equal(num, want[0]) and torch.equal(den, want[1])
    out_bytes = 2 * rows * VOCAB * 4
    row = {
        "name": name, "route": "cuda", "source": SOURCE, "replaces": REPLACES[name],
        "max_abs_err": err,
        "ms": time_ms(raw), "plain_ms": time_ms(plain),
        "bound_ms": (in_bytes + out_bytes) / HBM_BYTES_PER_S * 1e3, "bound_by": "bytes",
        "library_ms": time_ms(library_call(a, b, wire.indices)),
    }
    log(f"[timing] {name} N={n} rows={rows} k_cap={k} V={VOCAB}: kernel {row['ms']:.4f} ms "
        f"(wrapper call {time_ms(wrapper):.4f} ms), plain {row['plain_ms']:.4f} ms, "
        f"library scatter_add_ {row['library_ms']:.4f} ms, byte bound {row['bound_ms'] * 1e3:.2f} us "
        f"({in_bytes + out_bytes} B), max_abs_err {err}")
    return row


def main() -> int:
    device, card = phase_device()
    phase_build()
    phase_kernels(device)
    phase_small_input(device)

    ops.reset_launches()  # the main path's launches only, from here
    float_run = phase_main_path(device, quantize=False)
    assert ops.LAUNCHES == {"scatter_wire_sums": 2, "scatter_wire_sums_dequant": 0}, ops.LAUNCHES
    int8_run = phase_main_path(device, quantize=True)
    launches = dict(ops.LAUNCHES)
    assert launches == {"scatter_wire_sums": 2, "scatter_wire_sums_dequant": 2}, launches
    log(f"[main path] kernel launches {launches}")

    k_caps = {
        "scatter_wire_sums": max(k_cap_bucket(ks, VOCAB) for ks in float_run.per_client_k),
        "scatter_wire_sums_dequant": max(k_cap_bucket(ks, VOCAB) for ks in int8_run.per_client_k),
    }
    rows = []
    for name, k_cap in k_caps.items():
        row = phase_timing(name, k_cap, device)
        rows.append({**row, "launches": launches[name]})
    print(card)
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
