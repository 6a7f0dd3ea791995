"""dp × tp sharding of the causal LM (counterpart of
``crs_tpu.models.sharding``).

``crs_tpu`` places the params Megatron-style on a 2-D ``Mesh(("dp", "tp"))``
and lets GSPMD insert the collectives. The port runs one process per
device over ``torch.distributed`` and writes them out
(``transformer``'s ``mesh`` argument, ``parallel.collectives``):

- q / k / v and gate / up are column-parallel (split over tp by output
  column; q / k / v by whole kv-head groups), o and down row-parallel (split
  by input row; each rank's product summed over tp in f32);
- ``embed`` is split on vocab rows (a masked lookup summed over tp),
  ``lm_head`` on vocab columns (the logits all-gathered over tp at the loss
  and at the [B, V] sampling step); norms are replicated;
- the batch splits over dp; the loss is the global mean over valid tokens
  (the local sums, then the sum and the count over dp) and the gradients
  are summed over dp before a ``torch.optim`` step on each rank's shards.

``crs_tpu``'s docstring names a sequence-parallel activation constraint;
its code has none (only a placement of the logits), and none is ported.
Like ``crs_tpu``'s, :func:`shard_params` takes dense weights only: a
quantized weight raises.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional, Union

import torch
import torch.distributed as dist

from ..parallel.collectives import reduce_from_group
from ..parallel.mesh import _ensure_group, _rank_device, mesh_device
from .sampling import SamplingParams, generate_tokens
from .transformer import TransformerConfig, forward

__all__ = [
    "make_model_mesh", "param_pspecs", "shard_params", "param_leaves",
    "make_sharded_train_step", "sharded_loss_fn", "shard_batch", "sharded_generate_tokens",
]

Params = Dict[str, Any]
COL, ROW, REPL = (None, "tp"), ("tp", None), ()


def make_model_mesh(n_devices: Optional[int] = None, tp: Optional[int] = None,
                    device: Optional[Union[str, torch.device]] = None):
    """A (dp, tp) ``DeviceMesh`` over the first ``n_devices`` ranks (default:
    all). tp defaults to 2 when n is even and ≥ 2, else 1."""
    from torch.distributed.device_mesh import DeviceMesh

    dev = _rank_device(device)
    _ensure_group(dev)
    world = dist.get_world_size()
    n = world if n_devices is None else int(n_devices)
    if not 1 <= n <= world:
        raise ValueError(f"a mesh of {n} devices in a world of {world}")
    if tp is None:
        tp = 2 if n % 2 == 0 and n >= 2 else 1
    if n % tp:
        raise ValueError(f"{n} devices not divisible by tp={tp}")
    ranks = torch.arange(n).reshape(n // tp, tp)
    return DeviceMesh(dev.type, ranks, mesh_dim_names=("dp", "tp"))


def _spec_for(path: str):
    """``crs_tpu``'s placement of one parameter path, as a tuple of axis
    names per dim (``PartitionSpec``'s entries)."""
    if any(k in path for k in ("attn.q", "attn.k", "attn.v", "mlp.gate", "mlp.up")):
        return COL
    if "attn.o" in path or "mlp.down" in path:
        return ROW
    if path in ("embed", "lm_head"):
        return COL if path == "lm_head" else ROW
    return REPL


def _visit(path: str, node: Any, leaf: Callable[[str, Any], Any]) -> Any:
    if isinstance(node, dict):
        return {k: _visit(f"{path}.{k}" if path else k, v, leaf) for k, v in node.items()}
    if isinstance(node, list):
        return [_visit(path, v, leaf) for v in node]
    return leaf(path, node)


def param_pspecs(params: Params) -> Params:
    """The placement tree of ``params``: per path ``(None, "tp")``
    (column-parallel), ``("tp", None)`` (row-parallel) or ``()``
    (replicated), the entries of ``crs_tpu``'s ``PartitionSpec``s."""
    return _visit("", params, lambda path, _: _spec_for(path))


def _split_parts(path: str, cfg: TransformerConfig, cols: int):
    """Column widths of the parts a column-parallel weight concatenates:
    q | k | v for a fused ``qkv``, gate | up for ``gateup``."""
    hd = cfg.head_dim
    if path.endswith("attn.qkv"):
        return [cfg.num_heads * hd, cfg.num_kv_heads * hd, cfg.num_kv_heads * hd]
    if path.endswith("mlp.gateup"):
        return [cols // 2, cols // 2]
    return [cols]


def shard_params(params: Params, mesh, cfg: Optional[TransformerConfig] = None) -> Params:
    """This rank's shard of a dense params tree (``crs_tpu``'s
    ``shard_params``): column-parallel weights keep this tp rank's columns
    (a fused ``qkv`` / ``gateup`` split part by part), row-parallel ones its
    rows, replicated ones a copy; on the mesh's device. ``cfg`` is needed
    for a fused ``qkv``. Quantized weights raise, as ``crs_tpu``'s does not
    take them."""
    tp_size, tp_rank = mesh.size(1), mesh.get_local_rank("tp")
    dev = mesh_device(mesh)
    if cfg is not None and cfg.num_kv_heads % tp_size:
        raise ValueError(f"{cfg.num_kv_heads} kv-heads do not split over tp={tp_size}")

    def shard(path: str, w: Any):
        if not isinstance(w, torch.Tensor):
            raise TypeError(f"{path}: shard_params takes dense tensors (crs_tpu's does not "
                            f"take quantized weights), got {type(w).__name__}")
        spec = _spec_for(path)
        if spec == REPL:
            return w.to(dev, copy=True)
        dim = spec.index("tp")
        parts = [w]
        if dim == 1 and ("qkv" in path or "gateup" in path):
            if "qkv" in path and cfg is None:
                raise ValueError("shard_params needs cfg to split a fused qkv")
            parts = list(torch.split(w, _split_parts(path, cfg, w.shape[1]), dim=1))
        out = []
        for part in parts:
            if part.shape[dim] % tp_size:
                raise ValueError(f"{path}: {part.shape[dim]} does not split over tp={tp_size}")
            size = part.shape[dim] // tp_size
            out.append(part.narrow(dim, tp_rank * size, size))
        return torch.cat(out, dim=dim).to(dev).clone(memory_format=torch.contiguous_format)

    return _visit("", params, shard)


def param_leaves(params: Params) -> List[torch.Tensor]:
    """Every tensor of a params tree, in order (an optimizer's params)."""
    leaves: List[torch.Tensor] = []
    _visit("", params, lambda _, w: leaves.append(w))
    return leaves


def shard_batch(ids, mask, mesh):
    """This dp rank's rows of a batch (B % dp == 0) on the mesh's device."""
    dp = mesh.size(0)
    ids, mask = torch.as_tensor(ids), torch.as_tensor(mask)
    if ids.shape[0] % dp:
        raise ValueError(f"a batch of {ids.shape[0]} does not split over dp={dp}")
    per = ids.shape[0] // dp
    r = mesh.get_local_rank("dp")
    dev = mesh_device(mesh)
    return (ids[r * per:(r + 1) * per].to(dev, torch.long),
            mask[r * per:(r + 1) * per].to(dev, torch.bool))


def sharded_loss_fn(params: Params, cfg: TransformerConfig, ids: torch.Tensor,
                    mask: torch.Tensor, mesh) -> torch.Tensor:
    """Next-token softmax cross-entropy (optax's, the row max taken out
    without a gradient), the mean over the valid tokens of the whole batch:
    this dp rank's sum, summed over dp, over the global count. ``ids`` /
    ``mask`` are this rank's rows (:func:`shard_batch`). Its gradient on a
    rank is that rank's share: sum it over dp."""
    logits = forward(params, cfg, ids, mask, mesh=mesh)[:, :-1, :]
    shifted = logits - logits.amax(dim=-1, keepdim=True).detach()
    label = torch.gather(shifted, -1, ids[:, 1:, None])[..., 0]
    losses = torch.log(torch.exp(shifted).sum(dim=-1)) - label
    valid = mask[:, 1:] & mask[:, :-1]
    dp_group = mesh.get_group("dp")
    count = valid.sum().float()
    dist.all_reduce(count, group=dp_group)
    total = (losses * valid).sum()
    # the forward sum over dp; backward each rank keeps its own share
    return reduce_from_group(total, dp_group) / torch.clamp_min(count, 1.0)


def make_sharded_train_step(cfg: TransformerConfig, mesh, optimizer: torch.optim.Optimizer):
    """The dp × tp training step over ``optimizer``'s params (this rank's
    shards, e.g. ``param_leaves(shard_params(...))``): the loss, backward,
    the gradients summed over dp (in f32), and the optimizer's in-place
    update. ``step(params, ids, mask)`` takes this rank's rows and returns
    the global loss before the update."""
    dp_group = mesh.get_group("dp")
    owned = [p for group in optimizer.param_groups for p in group["params"]]
    for p in owned:
        p.requires_grad_(True)

    def step(params: Params, ids: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
        optimizer.zero_grad(set_to_none=True)
        loss = sharded_loss_fn(params, cfg, ids, mask, mesh)
        loss.backward()
        for p in owned:
            if p.grad is None:
                continue
            g = p.grad.float()
            dist.all_reduce(g, group=dp_group)
            p.grad.copy_(g)
        optimizer.step()
        return loss.detach()

    return step


def sharded_generate_tokens(params: Params, cfg: TransformerConfig, ids, mask,
                            generator: torch.Generator, sp: SamplingParams, mesh):
    """Multi-device serving: prefill and decode over the dp × tp mesh.
    ``params`` is this rank's shard (:func:`shard_params`), ``ids`` / ``mask``
    the whole left-padded batch (B % dp == 0), the same on every rank. Each
    rank decodes its dp rows with its own KV cache (kernel 10 on the local
    cache for ``kv_bits == 8`` where the gates hold); every rank returns the
    whole (tokens [B, T], lengths [B])."""
    dp = mesh.size(0)
    ids, mask = torch.as_tensor(ids), torch.as_tensor(mask)
    if ids.shape[0] % dp:
        raise ValueError(f"a batch of {ids.shape[0]} does not split over dp={dp}")
    dev = mesh_device(mesh)
    return generate_tokens(params, cfg, ids.to(dev, torch.long), mask.to(dev, torch.bool),
                           generator, sp, mesh=mesh)
