"""Device meshes and placement over them (the torch twin of the JAX
package's ``repro/launch/mesh.py``).

A cascade tier may run on its own mesh of devices with the axes

  * ``data``  — the tier's request rows and its KV block pool split into
    that many shards, one launch per shard per tick;
  * ``model`` — tensor parallelism: each data shard's launches split
    over that many model shards, one on each device of its row of the
    mesh (attention heads, FFN hidden units, experts and the vocabulary;
    ``repro_torch.models.sharding``).

The same mesh shards a train step (``repro_torch.launch.steps``'
``make_train_step(mesh=)`` / ``make_ltc_train_step(mesh=)``) and the
prefill and serve steps (``make_prefill_step(mesh=)`` /
``make_serve_step(mesh=)``): each data shard takes its rows of the batch
(``data.shard_batch``), each model shard its slices of the weights,
optimizer state and cache by their specs (``steps.place``).

A :class:`TierMesh` is a plain description: its axis names and a
row-major array of ``torch.device``s, the ``model`` axis last.  Building
one touches no device, so importing this module and building meshes over
``[torch.device("cpu")] * n`` works on a machine without a card.  A
device list may name one device more than once: the shards placed there
then share it (several data shards on one card, or the CPU tests).

:func:`make_production_mesh` and :func:`make_test_mesh` have the JAX
package's shapes — ``(16, 16)`` over ``("data", "model")``, ``(2, 16,
16)`` over ``("pod", "data", "model")``, and the small test meshes — so
that the dry-run's per-device accounting (``launch.dryrun``) compares
with JAX's one to one; they are built over ``torch.device("meta")``
unless given devices.  A ``pod`` axis is one more data axis: the steps
run ``pod × data`` data shards in row-major order (:attr:`TierMesh.grid`,
as ``sharding.data_axis_size`` and ``data.batch_pspec`` count them), and
a spec entry names the axes it splits a dim over — ``"data"`` (the fsdp
rule, replicated over ``pod``), ``("pod", "data")`` (a batch) or
``"model"`` — which :func:`spec_slice`, :func:`spec_gather` and
:func:`group_sum` read from the device's coordinates.

**Placed trees.**  A placed tree is a grid ``placed[e][j]`` of trees,
one a device of the mesh's :attr:`~TierMesh.grid` (``e`` the data shard,
``j`` the model shard): each leaf the device's slice of the global leaf
by its spec, whole along the dims the spec leaves unsplit, as a JAX
``NamedSharding`` gives each device its addressable shard.  A leaf the
spec replicates is held by every device it is replicated over.

**Collectives.**  :func:`all_reduce`, :func:`all_gather`,
:func:`spec_gather`, :func:`group_sum` and :func:`lse_merge` (the
sequence-split decode's merge of softmax partials) are written out as
device copies, adds and concatenations; each reports one event to an
active count (:func:`repro_torch.kernels.counting.collective`), which
``launch.hlo`` reads as JAX reads its HLO's collectives.
"""
from __future__ import annotations

import itertools
from dataclasses import dataclass
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.kernels import counting

# NVIDIA H100 80GB HBM3 (SXM, 700 W) data-sheet figures per card, for
# roofline arithmetic: f32 without tensor cores, dense TF32 and dense
# BF16 on them, HBM3 bandwidth and NVLink bandwidth each way
PEAK_FLOPS_F32 = 67e12          # FLOP/s
PEAK_FLOPS_TF32 = 495e12        # FLOP/s
PEAK_FLOPS_BF16 = 989e12        # FLOP/s
HBM_BW = 3.35e12                # bytes/s
NVLINK_BW = 450e9               # bytes/s each way

AXES = ("data", "model")


@dataclass(frozen=True, eq=False)
class TierMesh:
    """A grid of devices: ``devices`` an object array of
    ``torch.device`` with one dim an axis of ``axis_names``, ``model``
    last (``(data, model)`` for a cascade tier; ``(pod, data, model)``
    for the multi-pod production mesh)."""
    devices: np.ndarray
    axis_names: Tuple[str, ...] = AXES

    @property
    def shape(self) -> dict:
        """Axis sizes by name, as a JAX mesh's ``shape``."""
        return dict(zip(self.axis_names, self.devices.shape))

    @property
    def grid(self) -> np.ndarray:
        """The devices as ``[data shards, model shards]``: every axis
        before ``model`` flattened row-major into the data shards."""
        return self.devices.reshape(-1, self.devices.shape[-1])

    def data_devices(self) -> List[torch.device]:
        """The device of each data shard, in shard order: its model shard
        0's (column 0 of the grid), which holds the shard's gathered
        logits and its rows of a batch."""
        return list(self.grid[:, 0])

    def model_devices(self, d: int) -> List[torch.device]:
        """The devices of data shard ``d``'s model shards, in model shard
        order (row ``d`` of the grid)."""
        return list(self.grid[d, :])


def visible_devices() -> List[torch.device]:
    """``cuda:0 … cuda:{n-1}``: every card this process sees."""
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


def make_tier_mesh(data: int = 1, model: int = 1,
                   devices: Optional[Sequence] = None) -> TierMesh:
    """A ``(data, model)`` mesh over ``devices`` (default: the first
    ``data * model`` visible cards), which must hold exactly that many
    entries when given."""
    devs = (devices if devices is not None
            else visible_devices()[:data * model])
    return _mesh((data, model), AXES, devs, f"tier mesh {data}x{model}")


def _mesh(shape, axes, devices, what: str) -> TierMesh:
    devs = [torch.device(d) for d in devices]
    if len(devs) != int(np.prod(shape)):
        raise ValueError(f"{what} needs {int(np.prod(shape))} devices, got "
                         f"{len(devs)}")
    grid = np.empty(len(devs), dtype=object)
    grid[:] = devs
    return TierMesh(grid.reshape(shape), tuple(axes))


def make_production_mesh(*, multi_pod: bool = False,
                         over: Optional[Sequence] = None) -> TierMesh:
    """The JAX package's production mesh: ``(16, 16)`` over ``("data",
    "model")``, or with ``multi_pod`` ``(2, 16, 16)`` over ``("pod",
    "data", "model")``; over ``over`` (default ``torch.device("meta")``
    repeated: the dry-run's traces allocate nothing)."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else AXES
    n = int(np.prod(shape))
    return _mesh(shape, axes, [torch.device("meta")] * n
                 if over is None else over, "production mesh")


def make_test_mesh(devices: int = 8, *,
                   over: Optional[Sequence] = None) -> TierMesh:
    """The JAX package's small test mesh of ``devices`` devices:
    ``(devices // 4, 4)`` when 4 divides them, else ``(1, devices)``,
    over ``over`` (default ``torch.device("meta")`` repeated)."""
    shape = (devices // 4, 4) if devices % 4 == 0 else (1, devices)
    return _mesh(shape, AXES, [torch.device("meta")] * devices
                 if over is None else over, "test mesh")


def make_tier_meshes(shapes: Sequence[Tuple[int, int]],
                     devices: Optional[Sequence] = None) -> List[TierMesh]:
    """One mesh per cascade tier from ``[(data, model), ...]`` shapes.

    Devices are assigned contiguously from ``devices`` (default: the
    visible cards), so tiers occupy disjoint device sets when they fit
    side by side (tier 0 on the first ``d0*m0``, tier 1 on the next
    ``d1*m1``, ...); when a tier would run past the end, assignment wraps
    to device 0 and tiers share devices."""
    devs = (visible_devices() if devices is None
            else [torch.device(d) for d in devices])
    meshes, off = [], 0
    for data, model in shapes:
        n = data * model
        if n > len(devs):
            raise ValueError(f"tier mesh {data}x{model} needs {n} devices, "
                             f"only {len(devs)} available")
        if off + n > len(devs):
            off = 0                       # wrap: tiers share devices
        meshes.append(make_tier_mesh(data, model, devs[off:off + n]))
        off += n
    return meshes


def num_chips(mesh: TierMesh) -> int:
    return int(mesh.devices.size)


# --------------------------------------------------------------------------
# Placement by spec
# --------------------------------------------------------------------------


def axis_sizes(mesh) -> dict:
    """Axis sizes by name of anything with ``axis_names`` and
    ``devices.shape`` (a :class:`TierMesh`, or a JAX mesh)."""
    return dict(zip(mesh.axis_names, mesh.devices.shape))


def _grid_sizes(grid, sizes) -> dict:
    """``sizes``, or a placed grid's own ``(data, model)`` sizes."""
    return sizes or {"data": len(grid), "model": len(grid[0])}


def spec_axes(entry) -> tuple:
    """The mesh axes a spec entry splits its dim over: none for None,
    one for a name, several for a tuple (``("pod", "data")``)."""
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


def local_shape(shape, spec: Sequence, sizes: dict) -> tuple:
    """The shape one device holds of a leaf of global ``shape`` split by
    ``spec`` on a mesh of ``sizes``: each split dim divided by the
    product of its axes' sizes."""
    return tuple(n // int(np.prod([sizes[a] for a in spec_axes(e)]))
                 for n, e in zip(shape, spec))


def device_coords(sizes: dict, e: int, j: int) -> dict:
    """The mesh coordinates of grid device ``(e, j)``: ``j`` on
    ``model``, ``e`` unravelled row-major over the axes before it."""
    coords = {"model": j}
    for a in reversed([a for a in sizes if a != "model"]):
        coords[a] = e % sizes[a]
        e //= sizes[a]
    return coords


def _grid_index(sizes: dict, coords: dict) -> tuple:
    e = 0
    for a in sizes:
        if a != "model":
            e = e * sizes[a] + coords[a]
    return e, coords.get("model", 0)


def axis_members(sizes: dict, coords: dict, axes) -> list:
    """The grid devices ``(e, j)`` that differ from ``coords`` only along
    ``axes``, in the order of the part they hold of a dim split over
    ``axes`` (the first axis most significant)."""
    return [_grid_index(sizes, {**coords, **dict(zip(axes, idx))})
            for idx in itertools.product(*(range(sizes[a]) for a in axes))]


def spec_slice(t, spec: Sequence, coords: dict, sizes: dict):
    """The slice (a view) of the global leaf ``t`` that the device at
    ``coords`` holds by ``spec``: each dim whose entry names only axes of
    ``coords`` narrowed to the device's part of ``sizes`` (the product
    of its axes' sizes, the part index their coordinates row-major);
    a dim split over an axis ``coords`` leaves out stays whole."""
    for dim, entry in enumerate(spec):
        axes = spec_axes(entry)
        if not axes or any(a not in coords for a in axes):
            continue
        idx, parts = 0, 1
        for a in axes:
            idx, parts = idx * sizes[a] + coords[a], parts * sizes[a]
        n = t.shape[dim] // parts
        t = t.narrow(dim, idx * n, n)
    return t


def shard_leaf(t, spec: Sequence, index: int, m: int):
    """Model shard ``index``'s slice (a view) of ``t`` along the dim
    ``spec`` puts ``"model"`` on, of ``m`` equal slices; ``t`` itself
    when ``spec`` splits no dim over ``model``.  Data entries (the fsdp
    rule) are not sliced: a data shard holds every ``d_model`` row its
    launches read, the JAX package's all-gather done at placement."""
    return spec_slice(t, spec, {"model": index}, {"model": m})


def _subtrees(tree, like) -> list:
    """The subtrees of ``tree`` at the leaves of ``like`` (the same
    structure down to them), in ``tree_leaves`` order."""
    # imported here: the model layer imports this module
    from repro_torch.models.params import tree_map
    out = []
    tree_map(lambda _, t: out.append(t), like, tree)
    return out


def leaf_specs(tree, specs) -> list:
    """The spec of each leaf of ``tree``, in ``tree_leaves`` order
    (``specs`` a tree of tuples of the same structure)."""
    return [tuple(s) for s in _subtrees(specs, tree)]


def map_leaves(fn, specs, *grids) -> list:
    """``fn(spec, *parts)`` for each leaf of placed trees: ``parts`` the
    ``[e][j]`` grid of that leaf in each of ``grids`` (the first's trees
    give the leaves; a later grid may hold a subtree at each, as an
    optimizer's state does).  Returns the results in ``tree_leaves``
    order."""
    like = grids[0][0][0]
    flat = [[[_subtrees(t, like) for t in row] for row in g] for g in grids]
    return [fn(s, *([[ls[i] for ls in row] for row in f] for f in flat))
            for i, s in enumerate(leaf_specs(like, specs))]


def grid_of(like, per_leaf) -> list:
    """Placed trees of ``like``'s structure from ``per_leaf``, each
    leaf's ``[e][j]`` grid in ``tree_leaves`` order (as
    :func:`map_leaves` returns them)."""
    from repro_torch.models.params import tree_map
    out = []
    for e, row in enumerate(like):
        out.append([])
        for j, t in enumerate(row):
            it = iter(g[e][j] for g in per_leaf)
            out[-1].append(tree_map(lambda _: next(it), t))
    return out


def spec_gather(parts, spec: Sequence, sizes: Optional[dict] = None,
                device=None):
    """The global leaf from its slices ``parts[e][j]`` (the inverse of
    :func:`spec_slice` over a mesh of ``sizes``, default the grid's
    ``(data, model)``), on ``device`` (default: device ``(0, 0)``'s): one
    holder of each distinct slice, concatenated dim by dim."""
    sizes = _grid_sizes(parts, sizes)
    device = parts[0][0].device if device is None else device
    coords = device_coords(sizes, 0, 0)

    def build(dim, coords):
        if dim == len(spec):
            e, j = _grid_index(sizes, coords)
            return parts[e][j].to(device, non_blocking=True)
        axes = spec_axes(spec[dim])
        if not axes:
            return build(dim + 1, coords)
        return torch.cat([
            build(dim + 1, {**coords, **dict(zip(axes, idx))})
            for idx in itertools.product(*(range(sizes[a]) for a in axes))],
            dim)
    out = build(0, coords)
    counting.collective("all-gather", [out])
    return out


def all_reduce(parts: Sequence[torch.Tensor]) -> List[torch.Tensor]:
    """The sum of ``parts`` (one partial a device, each on its device) on
    every part's device: summed in order on the first part's device,
    then copied to each part's.  The copies are asynchronous
    device-to-device copies on the current streams, so no host sync;
    where the devices are the same it is a plain add, and every part's
    device gets the one result."""
    dev = parts[0].device
    total = parts[0]
    for p in parts[1:]:
        total = total + p.to(dev, non_blocking=True)
    out = [total.to(p.device, non_blocking=True) for p in parts]
    counting.collective("all-reduce", out)
    return out


def lse_merge(parts) -> list:
    """Softmax partials merged over devices that each attended their own
    keys (a sequence-split decode): ``parts[i] = (o, m, l)`` on member
    ``i``'s device, in key order — ``o`` the output over its keys
    normalised by its own sum (or None), ``m`` its max score (-inf where
    it saw no key), ``l`` its sum of ``exp(score - m)``.  In device order
    on the first part's device: the max ``M`` of the ``m``, each part's
    weight ``w = l · exp(m - M)`` (0 for a part that saw nothing), the
    sum ``L`` of the weights, and ``Σ w · o / L`` in ``o``'s dtype; then
    ``(o, M, L)`` copied to every part's device, as :func:`all_reduce`
    copies (asynchronous, no host sync).  A group of one returns its
    part as it is."""
    if len(parts) == 1:
        return list(parts)
    dev = parts[0][1].device
    ms = [m.to(dev, non_blocking=True) for _, m, _ in parts]
    top = ms[0]
    for m in ms[1:]:
        top = torch.maximum(top, m)
    ws = [l.to(dev, non_blocking=True) * torch.exp(m - top)
          for (_, _, l), m in zip(parts, ms)]
    total = ws[0]
    for w in ws[1:]:
        total = total + w
    out = None
    if parts[0][0] is not None:
        out = ws[0] * parts[0][0].to(dev, non_blocking=True)
        for w, (o, _, _) in zip(ws[1:], parts[1:]):
            out = out + w * o.to(dev, non_blocking=True)
        out = (out / total).to(parts[0][0].dtype)
    merged = [tuple(None if t is None else t.to(m.device, non_blocking=True)
                    for t in (out, top, total)) for _, m, _ in parts]
    counting.collective("all-reduce", [tuple(t for t in p if t is not None)
                                       for p in merged])
    return merged


def all_gather(parts: Sequence[torch.Tensor], dim: int) -> torch.Tensor:
    """``parts`` concatenated along ``dim`` in order, on the first
    part's device (asynchronous copies, no host sync)."""
    dev = parts[0].device
    out = torch.cat([p.to(dev, non_blocking=True) for p in parts], dim)
    counting.collective("all-gather", [out])
    return out


def group_sum(parts, axes, sizes: Optional[dict] = None) -> list:
    """``parts[e][j]`` (one tensor a grid device of a mesh of ``sizes``,
    default the grid's ``(data, model)``) summed over the devices that
    differ only along the mesh ``axes``: each device gets its group's
    sum (:func:`all_reduce`, in row-major device order, so every member
    holds the same bits).  No axis of more than one device: ``parts``."""
    sizes = _grid_sizes(parts, sizes)
    axes = [a for a in sizes if a in set(axes) and sizes[a] > 1]
    if not axes:
        return parts
    out = [[None] * len(parts[0]) for _ in parts]
    for e, row in enumerate(parts):
        for j in range(len(row)):
            if out[e][j] is not None:
                continue
            members = sorted(axis_members(sizes, device_coords(sizes, e, j),
                                          axes))
            for (a, b), t in zip(members, all_reduce(
                    [parts[a][b] for a, b in members])):
                out[a][b] = t
    return out


def sync_grads(grads, specs, sizes: Optional[dict] = None) -> list:
    """Data-parallel (and replicated-leaf) gradient sums: each leaf's
    gradient summed over the devices that hold the same slice of it —
    the mesh axes its spec does not split — so that every replica takes
    the whole gradient and steps alike.  ``grads`` and the result are
    placed trees on a mesh of ``sizes`` (default the grid's)."""
    sizes = _grid_sizes(grads, sizes)
    return grid_of(grads, map_leaves(
        lambda s, g: group_sum(g, set(sizes) - {
            a for entry in s for a in spec_axes(entry)}, sizes),
        specs, grads))
