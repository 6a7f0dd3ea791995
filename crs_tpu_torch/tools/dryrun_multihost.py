"""Multi-host dry run of the port: the sharded corpus scans and a
data-parallel training step across process boundaries (port of
``tools/dryrun_multihost.py``).

The JAX tool starts two processes, each a "host" of 4 virtual CPU devices,
and joins them with ``jax.distributed.initialize`` into one global mesh of
8 devices. The port runs one process per device
(:mod:`crs_tpu_torch.parallel.mesh`), so here a host is a group of
processes: the parent starts ``--hosts`` × ``--devices-per-host`` workers.
Each gets ``RANK``, ``WORLD_SIZE`` and ``LOCAL_RANK`` (its place within its
host) and, on the card, ``CUDA_VISIBLE_DEVICES`` set to its host's cards
(host h sees cards h·P … h·P + P − 1), as each node of a multi-host launch
sees only its own. The workers join through ``initialize_multihost`` at
``tcp://localhost:--port``: NCCL on the card, gloo with ``--device cpu``.

Every worker draws the JAX tool's inputs from one
``np.random.default_rng(0)`` stream (the corpus, the query noise, then the
token ids; :func:`inputs`) and runs

- :func:`scans`: ``sharded_topk`` over the fp32 corpus and
  ``sharded_topk_int8`` (rescore 32) over its int8 codes, in 512-row blocks
  on the 1-D ``corpus`` mesh; the top-10 must overlap exact search by ≥ 0.99
  (fp32) and ≥ 0.9 (int8), and every query must retrieve itself first;
- :func:`train_step`: one SGD(1e-3) step of a 2-layer f32 transformer, the
  batch split over every rank (``make_model_mesh(tp=1)``: pure data
  parallel, as the JAX tool's 1-D ``dp`` mesh); its loss must be finite.

Local rank 0 of each host prints ``MULTIHOST OK proc=<host> devices=<world>
fp32_overlap=… int8_overlap=… dp_loss=…``. The parent prints a failed
worker's last lines as ``proc <rank> FAILED:``, then ``MULTIHOST DRYRUN:
PASS`` or ``FAIL``, and exits 0 only if every worker passed. A worker that
has not ended after 600 s is killed, and so are the others once one fails
(they would wait for it in a collective).

A shard takes the kernel route only from 4 × 512 rows, as in ``crs_tpu``:
at 1 × 1 (4,196 rows a shard) the fp32 scan runs kernel 2 and the int8 scan
kernel 1; at the JAX tool's 2 × 4 (525 rows a shard) and at 2 × 2 (1,049)
every rank scans with the dense body, in both packages.

Usage (from the repository root):
  python -m crs_tpu_torch.tools.dryrun_multihost --device cpu     # 2 hosts × 4 workers, gloo
  python -m crs_tpu_torch.tools.dryrun_multihost                  # the visible cards over 2 hosts
  python -m crs_tpu_torch.tools.dryrun_multihost --hosts 1 --devices-per-host 1   # one card
"""

from __future__ import annotations

import argparse
import math
import os
import subprocess
import sys
import tempfile
import time
from pathlib import Path
from typing import List, Optional, Tuple

import numpy as np
import torch

from ..device import resolve_device

__all__ = ["inputs", "overlap", "scans", "train_step", "plan",
           "worker_command", "parent", "worker", "main"]

N, D, B, K = 4096 + 100, 128, 8, 10  # +100: the last shard is padded
BLOCK_SIZE, RESCORE_K = 512, 32
FP32_MIN_OVERLAP, INT8_MIN_OVERLAP = 0.99, 0.9
MODEL = dict(vocab_size=384, hidden_size=64, num_layers=2, num_heads=4, num_kv_heads=2,
             intermediate_size=128, max_seq_len=64)
BATCH, SEQ, LR = 8, 32, 1e-3
CPU_DEVICES_PER_HOST = 4  # the JAX tool's virtual devices per process
WORKER_TIMEOUT_S = 600
TAIL_LINES = 12
OK = "MULTIHOST OK"
PACKAGE_ROOT = str(Path(__file__).resolve().parents[2])


def inputs() -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(corpus [N, D] unit rows f32, queries [B, D] f32, token ids [BATCH,
    SEQ] int64 in 1..vocab − 1), drawn in the JAX tool's order."""
    rng = np.random.default_rng(0)
    vecs = rng.standard_normal((N, D)).astype(np.float32)
    vecs /= np.linalg.norm(vecs, axis=1, keepdims=True)
    queries = vecs[:B] + 0.01 * rng.standard_normal((B, D)).astype(np.float32)
    ids = rng.integers(1, MODEL["vocab_size"], (BATCH, SEQ)).astype(np.int64)
    return vecs, queries, ids


def overlap(got: np.ndarray, want: np.ndarray) -> float:
    """Mean share of each row's ids in ``want``'s row."""
    return float(np.mean([len(set(a) & set(b)) / want.shape[1] for a, b in zip(got, want)]))


def scans(mesh, vecs: np.ndarray, queries: np.ndarray) -> dict:
    """The fp32 and int8 sharded top-K over ``mesh``'s ``corpus`` axis →
    {"fp32": (scores, ids), "int8": (scores, ids), "fp32_overlap",
    "int8_overlap"}, the same on every rank. Raises AssertionError below
    the JAX tool's overlaps or when a query does not retrieve itself."""
    from ..ops.quant import scalar_quantize
    from ..parallel.mesh import mesh_device
    from ..parallel.sharded_index import shard_corpus, sharded_topk, sharded_topk_int8

    dev = mesh_device(mesh)
    want = np.argsort(-(queries @ vecs.T), axis=1)[:, :K]
    vs, valid_n = shard_corpus(vecs, mesh)
    q = torch.from_numpy(queries).to(dev)
    fp32 = sharded_topk(vs, q, K, valid_n, mesh, block_size=BLOCK_SIZE)
    got = fp32[1].cpu().numpy()
    fp32_overlap = overlap(got, want)
    if not fp32_overlap >= FP32_MIN_OVERLAP:
        raise AssertionError(f"fp32 sharded scan overlap {fp32_overlap}")
    if not (got[:, 0] == np.arange(B)).all():
        raise AssertionError(f"self-retrieval failed: {got[:, 0]}")
    codes, scales = scalar_quantize(torch.from_numpy(vecs).to(dev))
    cs, _ = shard_corpus(codes, mesh)
    ss, _ = shard_corpus(scales.reshape(-1, 1), mesh)
    int8 = sharded_topk_int8(cs, ss.reshape(-1), q, K, valid_n, mesh, rescore_k=RESCORE_K,
                             block_size=BLOCK_SIZE)
    int8_overlap = overlap(int8[1].cpu().numpy(), want)
    if not int8_overlap >= INT8_MIN_OVERLAP:
        raise AssertionError(f"int8 sharded scan overlap {int8_overlap}")
    return {"fp32": fp32, "int8": int8, "fp32_overlap": fp32_overlap,
            "int8_overlap": int8_overlap}


def train_step(mesh, ids: np.ndarray) -> Tuple[float, dict]:
    """One SGD(LR) step (no momentum) from ``init_params(0)`` on the (dp, 1)
    ``mesh`` (``make_model_mesh(tp=1)``): optax's mean cross-entropy over
    every next token of ``ids`` (none is padding), the gradients summed
    over dp → (the loss before the update, this rank's updated params)."""
    from ..models.sharding import make_sharded_train_step, param_leaves, shard_batch, shard_params
    from ..models.transformer import TransformerConfig, init_params
    from ..parallel.mesh import mesh_device

    if mesh.size(1) != 1:
        raise ValueError(f"the dry run's step is data-parallel only, got tp={mesh.size(1)}")
    cfg = TransformerConfig(**MODEL, dtype=torch.float32)
    params = shard_params(init_params(0, cfg, device=mesh_device(mesh)), mesh, cfg)
    step = make_sharded_train_step(cfg, mesh, torch.optim.SGD(param_leaves(params), lr=LR))
    ids_t = torch.from_numpy(ids)
    loss = float(step(params, *shard_batch(ids_t, torch.ones_like(ids_t, dtype=torch.bool),
                                           mesh)))
    if not math.isfinite(loss):
        raise AssertionError(f"data-parallel loss {loss}")
    return loss, params


def worker(host: int, port: int, device: str) -> None:
    """One rank (``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK`` from the parent):
    join, scan, step; local rank 0 prints the host's OK line."""
    import torch.distributed as dist

    from ..models.sharding import make_model_mesh
    from ..parallel.mesh import corpus_mesh, initialize_multihost

    rank, world, local = (int(os.environ[k]) for k in ("RANK", "WORLD_SIZE", "LOCAL_RANK"))
    if device == "cpu":
        torch.set_num_threads(1)  # the workers share the host's cores
    initialize_multihost(f"tcp://localhost:{port}", world, rank, device=device)
    vecs, queries, ids = inputs()
    found = scans(corpus_mesh(device=device), vecs, queries)
    loss, _ = train_step(make_model_mesh(tp=1, device=device), ids)
    if local == 0:
        print(f"{OK} proc={host} devices={world} fp32_overlap={found['fp32_overlap']:.2f} "
              f"int8_overlap={found['int8_overlap']:.2f} dp_loss={loss:.4f}", flush=True)
    dist.destroy_process_group()


def plan(hosts: int, devices_per_host: Optional[int],
         device: Optional[str]) -> Tuple[int, Optional[List[List[str]]]]:
    """(devices per host, each host's cards, or None on the CPU). The CPU
    takes CPU_DEVICES_PER_HOST by default; the card the visible cards ÷
    hosts. Too few cards raise; nothing falls back to the CPU."""
    dev = resolve_device(device)
    if hosts < 1 or (devices_per_host is not None and devices_per_host < 1):
        raise ValueError(f"--hosts {hosts} and --devices-per-host {devices_per_host} must be ≥ 1")
    if dev.type == "cpu":
        return devices_per_host or CPU_DEVICES_PER_HOST, None
    count = torch.cuda.device_count()
    visible = os.environ.get("CUDA_VISIBLE_DEVICES")
    cards = ([c.strip() for c in visible.split(",") if c.strip()] if visible is not None
             else [str(i) for i in range(count)])[:count]
    per = devices_per_host or len(cards) // hosts
    if per < 1 or hosts * per > len(cards):
        raise RuntimeError(f"{hosts} hosts × {per} devices: {len(cards)} visible cards, and "
                           f"NCCL takes one process a card (--device cpu runs on the CPU)")
    return per, [cards[h * per:(h + 1) * per] for h in range(hosts)]


def worker_command(host: int, port: int, device: str) -> List[str]:
    return [sys.executable, "-m", "crs_tpu_torch.tools.dryrun_multihost", "--worker", str(host),
            "--port", str(port), "--device", device]


def _tail(out: str) -> str:
    return "\n".join(out.strip().splitlines()[-TAIL_LINES:])


def parent(hosts: int, per_host: int, port: int, cards: Optional[List[List[str]]]) -> int:
    """Start every worker, wait for them (WORKER_TIMEOUT_S; the rest killed
    once one fails) and report; 0 only if every worker passed."""
    device = "cpu" if cards is None else "cuda"
    world = hosts * per_host
    path = os.pathsep.join(p for p in (PACKAGE_ROOT, os.environ.get("PYTHONPATH")) if p)
    procs = []
    for rank in range(world):
        host, local = divmod(rank, per_host)
        env = dict(os.environ, RANK=str(rank), WORLD_SIZE=str(world), LOCAL_RANK=str(local),
                   PYTHONPATH=path)
        if cards is None:
            env["OMP_NUM_THREADS"] = "1"
        else:
            env["CUDA_VISIBLE_DEVICES"] = ",".join(cards[host])
        out = tempfile.TemporaryFile(mode="w+")
        procs.append((subprocess.Popen(worker_command(host, port, device), stdout=out,
                                       stderr=subprocess.STDOUT, env=env), out))
    deadline = time.monotonic() + WORKER_TIMEOUT_S
    ok = True
    try:
        while True:
            codes = [p.poll() for p, _ in procs]
            if None not in codes or any(codes) or time.monotonic() > deadline:
                break
            time.sleep(0.1)
        failed = [rank for rank, code in enumerate(codes) if code]
        for rank, (p, out) in enumerate(procs):
            note = ""
            if p.poll() is None:
                p.kill()
                p.wait()
                note = (f"proc {rank}: stopped after proc {failed[0]} failed" if failed
                        else f"proc {rank}: TIMEOUT")
            out.seek(0)
            text = out.read() + note
            lines = [line for line in text.splitlines() if line.startswith(OK)]
            if p.returncode != 0 or (rank % per_host == 0) != bool(lines):
                ok = False
                print(f"proc {rank} FAILED:\n{_tail(text)}")
            elif lines:
                print(lines[0])
    finally:  # an interrupted parent leaves no worker behind
        for p, out in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
            out.close()
    print("MULTIHOST DRYRUN:", "PASS" if ok else "FAIL", flush=True)
    return 0 if ok else 1


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--hosts", type=int, default=2)
    ap.add_argument("--devices-per-host", type=int, default=None,
                    help="processes (devices) per host: 4 on the CPU, the visible cards ÷ "
                         "hosts on the card")
    ap.add_argument("--port", type=int, default=12399)
    ap.add_argument("--device", default=None, help="cuda (the default) or cpu")
    ap.add_argument("--worker", type=int, default=None, help=argparse.SUPPRESS)  # its host
    args = ap.parse_args(argv)
    if args.worker is not None:
        worker(args.worker, args.port, str(resolve_device(args.device)))
        return 0
    per_host, cards = plan(args.hosts, args.devices_per_host, args.device)
    return parent(args.hosts, per_host, args.port, cards)


if __name__ == "__main__":
    sys.exit(main())
