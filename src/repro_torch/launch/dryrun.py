"""Multi-pod dry run (port of ``repro.launch.dryrun``).

For an (architecture x input shape) cell, run one step on the
production mesh -- (16,16) single pod or (2,16,16) multi-pod -- as rank
0 of a ``fake`` world of 512 ranks in this one process (its collectives
move nothing), on ``meta`` DTensors: no parameter, optimizer state,
batch or cache is allocated.  The step runs under the cost counter
(``analysis/cost.py``), which gives the rank's FLOPs, bytes, collective
bytes by kind and its peak of live bytes, and the record goes to
``experiments/dryrun_torch/<cell_id>.json``.

Run one cell:   PYTHONPATH=src python -m repro_torch.launch.dryrun \\
                    --arch qwen2-0.5b --shape train_4k [--multi-pod]
Run everything: PYTHONPATH=src python -m repro_torch.launch.dryrun --all
(``--all`` starts one subprocess per cell, as the JAX dry run does.)

The record keeps the keys of the JAX package's ``run_one`` where they
have a counterpart: ``hlo_walker_per_device`` holds the cost counter's
figures (``Cost.as_dict()``, the walker's keys), ``lower_s`` the time of
building and running the cell, and ``memory_analysis`` the arguments'
local bytes, the outputs' (those not updated in place), the temporaries'
(peak less arguments) and ``peak_estimate_bytes_per_device``, the
measured high-water mark of live local bytes.  Keys without a
counterpart are left out: ``compile_s`` (nothing is compiled),
``xla_cost_analysis`` (XLA's own count) and ``alias_bytes_per_device``
(the port updates donated state in place).  Loops run every iteration
eagerly, so there are no scan trip counts to recover.  Added: ``fits``,
the peak against ``HBM_BYTES - HBM_RESERVE``, and ``roofline_source``.

The roofline denominators are NVIDIA's datasheet figures for the H100
80GB HBM3 (SXM, 700 W), not measurements: 989 TFLOP/s dense bf16,
3.35 TB/s HBM3, 450 GB/s NVLink each way.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

RESULT_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..",
                          "..", "..", "experiments", "dryrun_torch")

# NVIDIA H100 80GB HBM3 (SXM, 700 W) datasheet figures, per card
ROOFLINE_SOURCE = "NVIDIA H100 80GB HBM3 (SXM, 700 W) datasheet"
PEAK_FLOPS = 989e12      # dense bf16 FLOP/s
HBM_BW = 3.35e12         # B/s
LINK_BW = 450e9          # NVLink 4, B/s each way
HBM_BYTES = 80 * 2**30
# kept free of the step: the CUDA context, NCCL's buffers, allocator slack
HBM_RESERVE = 4 * 2**30

WORLD = 512              # the fake world: the multi-pod mesh's ranks


def cell_id(arch, shape, multi_pod, tag=""):
    pod = "multipod" if multi_pod else "pod"
    suffix = f"_{tag}" if tag else ""
    return f"{arch}__{shape}__{pod}{suffix}"


def run_one(arch: str, shape_name: str, multi_pod: bool,
            tag: str = "") -> dict:
    """One cell, in this process (which starts the fake world once)."""
    from repro_torch.configs import get_config
    from repro_torch.launch.cells import build_cell, lower_cell
    from repro_torch.launch.mesh import make_production_mesh, start_fake_world
    from repro_torch.models.config import SHAPE_BY_NAME, cell_is_applicable

    cfg = get_config(arch)
    shape = SHAPE_BY_NAME[shape_name]
    ok, why = cell_is_applicable(cfg, shape)
    rec = {
        "arch": arch, "shape": shape_name,
        "mesh": "(2,16,16) pod,data,model" if multi_pod
        else "(16,16) data,model",
        "multi_pod": multi_pod, "tag": tag,
    }
    if not ok:
        rec["status"] = "skipped"
        rec["skip_reason"] = why
        return rec

    n_chips = 512 if multi_pod else 256
    start_fake_world(WORLD)
    mesh = make_production_mesh(multi_pod=multi_pod)
    t0 = time.time()
    cell = build_cell(arch, shape_name, mesh)
    low = lower_cell(cell)
    t1 = time.time()
    cost = low.cost

    # roofline terms: seconds per step per card
    compute_s = cost.flops / PEAK_FLOPS
    memory_s = cost.hbm_bytes / HBM_BW
    collective_s = cost.total_collective_bytes / LINK_BW

    # model flops: 6 N D (train) / 2 N_active D (single forward)
    n_active = cfg.param_count(active_only=True)
    if shape.phase == "train":
        tokens = shape.global_batch * shape.seq_len
        model_flops = 6.0 * n_active * tokens
    elif shape.phase == "prefill":
        tokens = shape.global_batch * shape.seq_len
        model_flops = 2.0 * n_active * tokens
    else:
        tokens = shape.global_batch  # one token per request
        model_flops = 2.0 * n_active * tokens

    terms = {
        "compute_s": compute_s,
        "memory_s": memory_s,
        "collective_s": collective_s,
    }
    dominant = max(terms, key=terms.get)
    limit = HBM_BYTES - HBM_RESERVE

    rec.update({
        "status": "ok",
        "n_chips": n_chips,
        "lower_s": round(t1 - t0, 2),
        "memory_analysis": {
            "argument_bytes_per_device": low.argument_bytes,
            "output_bytes_per_device": low.output_bytes,
            "temp_bytes_per_device": low.temp_bytes,
            "peak_estimate_bytes_per_device": low.peak_bytes,
        },
        "hlo_walker_per_device": cost.as_dict(),
        "model_flops_total": model_flops,
        "model_flops_per_device": model_flops / n_chips,
        "useful_flops_fraction":
            (model_flops / n_chips) / cost.flops if cost.flops else None,
        "roofline_terms_s": terms,
        "roofline_source": ROOFLINE_SOURCE,
        "dominant_term": dominant,
        "tokens_per_step": tokens,
        "hbm_limit_bytes": limit,
        "fits": low.peak_bytes <= limit,
    })
    return rec


def cells_to_run(archs=None, shapes=None):
    from repro_torch.configs import ARCHS
    from repro_torch.models.config import SHAPES
    archs = archs or sorted(ARCHS)
    shapes = shapes or [s.name for s in SHAPES]
    for a in archs:
        for s in shapes:
            yield a, s


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch")
    ap.add_argument("--shape")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--tag", default="")
    ap.add_argument("--force", action="store_true")
    args = ap.parse_args(argv)

    os.makedirs(RESULT_DIR, exist_ok=True)
    src = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))

    if args.all:
        failures = []
        for arch, shape in cells_to_run():
            for mp in (False, True):
                cid = cell_id(arch, shape, mp, args.tag)
                path = os.path.join(RESULT_DIR, cid + ".json")
                if os.path.exists(path) and not args.force:
                    print(f"[skip-cached] {cid}")
                    continue
                cmd = [sys.executable, "-m", "repro_torch.launch.dryrun",
                       "--arch", arch, "--shape", shape]
                if mp:
                    cmd.append("--multi-pod")
                if args.tag:
                    cmd += ["--tag", args.tag]
                print(f"[run] {cid}", flush=True)
                r = subprocess.run(cmd, capture_output=True, text=True,
                                   env={**os.environ, "PYTHONPATH": src})
                if r.returncode != 0:
                    failures.append(cid)
                    print(f"[FAIL] {cid}\n{r.stdout[-2000:]}"
                          f"\n{r.stderr[-4000:]}", flush=True)
                else:
                    print(r.stdout.strip().splitlines()[-1], flush=True)
        print("\nALL OK" if not failures else f"\nFAILURES: {failures}")
        sys.exit(1 if failures else 0)

    assert args.arch and args.shape, "--arch and --shape required"
    meshes = [args.multi_pod] if not args.both_meshes else [False, True]
    for mp in meshes:
        rec = run_one(args.arch, args.shape, mp, args.tag)
        cid = cell_id(args.arch, args.shape, mp, args.tag)
        path = os.path.join(RESULT_DIR, cid + ".json")
        with open(path, "w") as f:
            json.dump(rec, f, indent=2)
        print(f"[done] {cid}: status={rec['status']} "
              f"dominant={rec.get('dominant_term')} "
              f"lower_s={rec.get('lower_s')} path={path}")


if __name__ == "__main__":
    main()
