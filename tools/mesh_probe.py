"""Phase 9 of ``chip_smoke.py`` on its own: ``python3 tools/mesh_probe.py``
on a machine with one CUDA card (no kernel is built: the phase runs no
hand-written kernel).

Prints the card, then the phase's lines: (a) yi-9b (4 layers), mamba2-130m
and granite-moe-1b-a400m at their published widths, train step, prefill
and decode on DTensors over a 1x1 NCCL mesh against the plain steps; (b)
the dry run of yi-9b x train_4k on the single- and multi-pod meshes,
mamba2-130m x long_500k and granite-moe-1b-a400m x decode_32k; (c) the dry
run at (a)'s 1x1 mesh against (a)'s real yi-9b train step; (d) each of (a)'s
models and a one-period cut of jamba-1.5-large-398b, one train step with
remat against two without: loss, parameters, peaks and ms.

``--repeat N`` runs (a)'s steps N times instead, plain and on the mesh in
turn, with (b)'s dry runs in processes beside them as in the phase, and
prints for each model and run how its loss, logits and updated parameters
compare with the first plain run, the first mesh run, and this run's plain
twin: whether each step is repeatable on the card.  It first holds AdamW's
per-client norm on the card to the sum over each leaf flattened in
row-major order (bitwise), on row-major and transposed leaves.
"""

import argparse
import os
import subprocess
import sys
import tempfile
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import torch  # noqa: E402
import torch.distributed as dist  # noqa: E402

import chip_smoke  # noqa: E402


def compare(got: dict, want: dict, p0: dict) -> str:
    """Loss, prefill and decode logits: "=" bitwise, else max |got - want|;
    parameters: the leaves not bitwise and the largest off by its update."""
    parts = []
    for key in ("loss", "prefill", "decode"):
        equal, err = chip_smoke.mesh_diff(got[key], want[key])
        parts.append(f"{key} {'=' if equal else f'{err:.3g}'}")
    unequal = [k for k in want["params"] if not torch.equal(got["params"][k], want["params"][k])]
    rel = max((chip_smoke.update_rel(got["params"][k], want["params"][k], p0[k])
               for k in unequal), default=0.0)
    parts.append(f"params {len(unequal)} of {len(want['params'])} not bitwise"
                 + (f" (largest {rel:.3g} of its update)" if unequal else ""))
    return ", ".join(parts)


def check_norm(device) -> None:
    from repro_torch.optim import global_norm

    gen = torch.Generator(device=device).manual_seed(0)
    for transpose in (False, True):
        for dtype in (torch.float32, torch.bfloat16):
            grads = {k: torch.randn(s, generator=gen, device=device).to(dtype)
                     for k, s in (("w", (1, 4096, 11008)), ("b", (1, 4096)),
                                  ("e", (1, 4, 1024, 33)))}
            if transpose:
                grads = {k: g.transpose(1, -1) for k, g in grads.items()}
            flat = sum(torch.square(g.float()).reshape(1, -1).sum(dim=1) for g in grads.values())
            assert torch.equal(global_norm(grads), torch.sqrt(flat)), (transpose, dtype)
    print("[probe] AdamW's per-client norm bitwise the row-major flattened sum on the card "
          "(fp32 and bf16 leaves, row-major and transposed)", flush=True)


def repeat_a(device, card: str, n: int) -> None:
    from repro_torch.launch.mesh import make_host_mesh

    check_norm(device)
    tmp = tempfile.mkdtemp(prefix="dryrun_")
    env = dict(os.environ, PYTHONPATH=str(Path(chip_smoke.__file__).resolve().parent / "src"))
    dry = [subprocess.Popen([sys.executable, "-m", "repro_torch.launch.dryrun", "--arch", a,
                             "--shape", s, "--out", tmp, "--device", "cuda"]
                            + (["--multi-pod"] if multi else []), env=env,
                            stdout=subprocess.DEVNULL, stderr=subprocess.DEVNULL)
           for a, s, multi in chip_smoke.MESH_DRYRUNS]
    try:
        dist.init_process_group("nccl", store=dist.HashStore(), rank=0, world_size=1)
        mesh = make_host_mesh((1, 1), device="cuda")
        for name, cfg in chip_smoke.mesh_models().items():
            first = {}
            for i in range(n):
                plain = chip_smoke.mesh_run(cfg, device)
                on_mesh = chip_smoke.mesh_run(cfg, device, mesh)
                first.setdefault("plain", plain)
                first.setdefault("mesh", on_mesh)
                p0 = first["plain"]["init"]
                print(f"[probe {name} run {i}] plain against plain run 0: "
                      f"{compare(plain, first['plain'], p0)}; mesh against mesh run 0: "
                      f"{compare(on_mesh, first['mesh'], p0)}; mesh against this run's plain: "
                      f"{compare(on_mesh, plain, p0)}; {card}", flush=True)
                del plain, on_mesh
                torch.cuda.empty_cache()
            del first
            torch.cuda.empty_cache()
        dist.destroy_process_group()
    finally:
        for p in dry:
            p.kill()
            p.wait()


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--repeat", type=int, default=0,
                    help="run (a)'s steps this many times and compare the runs")
    args = ap.parse_args()
    device, card = chip_smoke.phase_device()
    print(card, flush=True)
    if args.repeat:
        repeat_a(device, card, args.repeat)
    else:
        chip_smoke.phase_production_mesh(device, card)
