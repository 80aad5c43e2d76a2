"""Device mesh for the sharded engine (port of vbx_tpu.parallel.mesh).

Axes:
  'dp' — data parallel over recordings (independent; no communication)
  'sp' — sequence parallel over the frames of a recording (the
         boundary-operator exchange of parallel.fb_blockwise)

vbx_tpu's mesh is a jax.sharding.Mesh under shard_map, single-process by
contract (its pipeline rejects jax.process_count() > 1). The port's mesh is
the same thing in one process: a [n_dp, n_sp] grid of torch devices, and
the two collectives the engine needs, written as explicit sums and stacks
of tensors moved between the shards' devices. A device may appear more
than once: a 1 x 4 mesh over one card repeated runs the four shards one
after another on that card, and the CPU tests build meshes of CPU copies
(the counterpart of XLA's forced host device count).
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import torch

from vbx_tpu_torch.utils.bucketing import T_QUANTUM


class Mesh:
    """A ('dp', 'sp') grid of torch devices for one process.

    `devices[r][k]` holds shard k of dp row r. `shape` is
    {'dp': n_dp, 'sp': n_sp}, as jax.sharding.Mesh.shape is."""

    def __init__(self, devices: Sequence[Sequence]):
        grid = [[torch.device(d) for d in row] for row in devices]
        if not grid or not grid[0] or any(len(r) != len(grid[0])
                                          for r in grid):
            raise ValueError("a mesh needs a non-empty rectangular grid of "
                             "devices")
        self.devices: List[List[torch.device]] = grid
        self.shape = {"dp": len(grid), "sp": len(grid[0])}

    @property
    def size(self) -> int:
        return self.shape["dp"] * self.shape["sp"]

    @property
    def first_device(self) -> torch.device:
        """Where the sharded engine assembles its results."""
        return self.devices[0][0]

    def _row(self, xs: Sequence[torch.Tensor]) -> None:
        if len(xs) != self.shape["sp"]:
            raise ValueError(f"a collective over 'sp' takes one tensor per "
                             f"shard ({self.shape['sp']}), got {len(xs)}")

    def psum(self, xs: Sequence[torch.Tensor]) -> List[torch.Tensor]:
        """Sum over the 'sp' shards of one dp row: xs[k] lives on shard k's
        device; every shard gets the same total (added in shard order on
        shard 0's device), on its own device."""
        self._row(xs)
        total = xs[0]
        for x in xs[1:]:
            total = total + x.to(total.device)
        return [total.to(x.device) for x in xs]

    def all_gather(self, xs: Sequence[torch.Tensor]) -> List[torch.Tensor]:
        """Stack the 'sp' shards' tensors of one dp row along a new axis 0;
        every shard gets the stack on its own device."""
        self._row(xs)
        stacked = torch.stack([x.to(xs[0].device) for x in xs])
        return [stacked.to(x.device) for x in xs]


def check_sp_divides_buckets(mesh: Mesh) -> None:
    """Raise ValueError unless the mesh's 'sp' extent divides the smallest
    frame bucket: T buckets are powers of two >= T_QUANTUM
    (utils.bucketing), so every bucket then splits evenly over the 'sp'
    shards. The corpus pass and the service check their mesh with it."""
    n_sp = mesh.shape["sp"]
    if T_QUANTUM % n_sp:
        raise ValueError(f"mesh 'sp' extent {n_sp} must divide the smallest "
                         f"frame bucket ({T_QUANTUM})")


def make_mesh(n_dp: Optional[int] = None, n_sp: int = 1,
              devices: Optional[Sequence] = None, device=None) -> Mesh:
    """Build a ('dp', 'sp') mesh over n_dp * n_sp devices.

    devices: an explicit list (it may repeat a device). Otherwise `device`
    picks them: 'cuda' (the default) takes the visible cards, as vbx_tpu
    takes jax.devices(); 'cpu' gives n_dp * n_sp entries of the CPU. With
    n_dp omitted, every listed device is used, split by n_sp (a CPU mesh
    then has n_dp = 1).
    """
    if n_sp < 1 or (n_dp is not None and n_dp < 1):
        raise ValueError(f"mesh extents must be positive, got n_dp={n_dp}, "
                         f"n_sp={n_sp}")
    if devices is None:
        dev = torch.device("cuda" if device is None else device)
        if dev.type == "cpu":
            devices = [dev] * ((n_dp or 1) * n_sp)
        elif dev.type == "cuda":
            devices = [torch.device("cuda", i)
                       for i in range(torch.cuda.device_count())]
        else:
            raise ValueError(f"make_mesh runs on cuda or cpu, not {dev}")
    devices = [torch.device(d) for d in devices]
    if n_dp is None:
        if len(devices) % n_sp:
            raise ValueError(f"{len(devices)} devices not divisible by "
                             f"n_sp={n_sp}")
        n_dp = len(devices) // n_sp
    need = max(n_dp, 1) * n_sp
    if need > len(devices):
        raise ValueError(f"need {need} devices, have {len(devices)}")
    return Mesh([devices[r * n_sp:(r + 1) * n_sp] for r in range(n_dp)])


def parse_mesh(spec: Optional[str], device=None) -> Optional[Mesh]:
    """CLI mesh spec 'DPxSP' (e.g. '4x2') -> Mesh on `device`, or None for
    None/''."""
    if not spec:
        return None
    try:
        n_dp, n_sp = (int(v) for v in spec.lower().split("x"))
    except ValueError:
        raise ValueError(f"mesh spec must look like 4x2, got {spec!r}")
    return make_mesh(n_dp=n_dp, n_sp=n_sp, device=device)


def parse_mesh_arg(spec: Optional[str], device=None) -> Optional[Mesh]:
    """parse_mesh with CLI error semantics: a bad spec (or a spec needing
    more devices than available) exits with a clean `--mesh: ...` message
    instead of a traceback."""
    try:
        return parse_mesh(spec, device=device)
    except ValueError as exc:
        raise SystemExit(f"--mesh: {exc}")
