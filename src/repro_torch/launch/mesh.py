"""Per-tier device meshes for multi-device serving (the torch twin of the
JAX package's ``repro/launch/mesh.py``).

A cascade tier may run on its own mesh of devices with the axes

  * ``data``  — the tier's request rows and its KV block pool split into
    that many shards, one launch per shard per tick;
  * ``model`` — tensor parallelism: each data shard's launches split
    over that many model shards, one on each device of its row of the
    mesh (attention heads, FFN hidden units, experts and the vocabulary;
    ``repro_torch.models.sharding``).

The same mesh shards a train step (``repro_torch.launch.steps``'
``make_train_step(mesh=)`` / ``make_ltc_train_step(mesh=)``): each data
shard takes its rows of the batch (``data.shard_batch``), each model
shard its slices of the weights and optimizer state by their specs
(``steps.place``).

A :class:`TierMesh` is a plain description: its shape ``(data, model)``,
its axis names and a row-major array of ``torch.device``s.  Building one
touches no device, so importing this module and building meshes over
``[torch.device("cpu")] * n`` works on a machine without a card.  A
device list may name one device more than once: the shards placed there
then share it (several data shards on one card, or the CPU tests).

The TPU pod meshes of the JAX module (``make_production_mesh``,
``make_test_mesh``) serve its dry-run and roofline tooling, which comes
with a later slice of the port.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

# NVIDIA H100 80GB HBM3 (SXM, 700 W) data-sheet figures per card, for
# roofline arithmetic: f32 without tensor cores, dense TF32 on them, HBM3
# bandwidth and NVLink bandwidth each way
PEAK_FLOPS_F32 = 67e12          # FLOP/s
PEAK_FLOPS_TF32 = 495e12        # FLOP/s
HBM_BW = 3.35e12                # bytes/s
NVLINK_BW = 450e9               # bytes/s each way

AXES = ("data", "model")


@dataclass(frozen=True, eq=False)
class TierMesh:
    """A ``(data, model)`` grid of devices for one cascade tier:
    ``devices`` is a ``[data, model]`` object array of ``torch.device``."""
    devices: np.ndarray
    axis_names: Tuple[str, str] = AXES

    @property
    def shape(self) -> dict:
        """Axis sizes by name, as a JAX mesh's ``shape``."""
        return dict(zip(self.axis_names, self.devices.shape))

    def data_devices(self) -> List[torch.device]:
        """The device of each data shard, in shard order: its model shard
        0's (column 0 of the mesh), which holds the shard's gathered
        logits and its rows of a train batch."""
        return list(self.devices[:, 0])

    def model_devices(self, d: int) -> List[torch.device]:
        """The devices of data shard ``d``'s model shards, in model shard
        order (row ``d`` of the mesh)."""
        return list(self.devices[d, :])


def visible_devices() -> List[torch.device]:
    """``cuda:0 … cuda:{n-1}``: every card this process sees."""
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


def make_tier_mesh(data: int = 1, model: int = 1,
                   devices: Optional[Sequence] = None) -> TierMesh:
    """A ``(data, model)`` mesh over ``devices`` (default: the first
    ``data * model`` visible cards), which must hold exactly that many
    entries when given."""
    devs = ([torch.device(d) for d in devices] if devices is not None
            else visible_devices()[:data * model])
    if len(devs) != data * model:
        raise ValueError(f"tier mesh {data}x{model} needs {data * model} "
                         f"devices, got {len(devs)}")
    grid = np.empty(len(devs), dtype=object)
    grid[:] = devs
    return TierMesh(grid.reshape(data, model))


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
