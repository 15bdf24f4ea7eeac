"""Device mesh construction — THE module that declares mesh topology
(PyTorch port).

Counterpart of horaedb_tpu/parallel/mesh.py.  A mesh is an explicit,
ordered list of `torch.device`s arranged over named axes (row-major):
the port runs every slot of a mesh from ONE controller process, as the
JAX package's `shard_map` programs do, and carries each collective out
as copies plus a reduction in fixed rank order (parallel/scan.py).

Two shapes live here:

  segment_mesh  the 1-D mesh over the segment (time-window) axis, kept
                for the device_sort merge rounds, the [scan]
                mesh_devices aggregate rounds and the multi-process
                tier (parallel/multihost.py);
  scan_mesh     the 2-D (time, series) mesh of the in-region scan
                ([scan.mesh]): plan segments shard along `time` (one
                merge window per time slot, plan order), group blocks
                along `series`.

A device list may name one device more than once: slots are then
logical, several on one card (or on the CPU), which is how the tests
run an 8-slot mesh on the CPU and chip_smoke.py a 4 x 2 mesh on one
card.  `local_devices` is the list a reader takes when its config does
not name one: every local card of the reader's device type, or the list
`set_local_devices` installed.
"""

from __future__ import annotations

import contextlib
from typing import Optional, Sequence

from horaedb_tpu_torch.common.error import ensure

SEGMENT_AXIS = "seg"

# the 2-D scan mesh's axis names ([scan.mesh])
TIME_AXIS = "time"
SERIES_AXIS = "series"

# the installed local device list (None: discover)
_LOCAL_DEVICES: Optional[list] = None


class Mesh:
    """An ordered list of devices over named axes (row-major: the last
    axis varies fastest).  `shape` maps each axis name to its size;
    `devices` is the flat slot list, `size` its length."""

    def __init__(self, devices: Sequence, axis_names: tuple,
                 axis_sizes: tuple) -> None:
        import torch

        n = 1
        for s in axis_sizes:
            n *= int(s)
        ensure(len(devices) == n and n > 0,
               f"mesh of shape {tuple(axis_sizes)} needs {n} devices, got "
               f"{len(devices)}")
        self.devices = [torch.device(d) for d in devices]
        self.axis_names = tuple(axis_names)
        self.shape = {a: int(s) for a, s in zip(axis_names, axis_sizes)}
        self.size = n
        kinds = {d.type for d in self.devices}
        ensure(len(kinds) == 1,
               f"a mesh spans one device type, got {sorted(kinds)}")

    def slot(self, *index: int) -> int:
        """Flat slot number of an index over the mesh axes."""
        ensure(len(index) == len(self.axis_names),
               f"mesh index needs {len(self.axis_names)} coordinates")
        flat = 0
        for a, i in zip(self.axis_names, index):
            flat = flat * self.shape[a] + int(i)
        return flat

    def coords(self, slot: int) -> tuple:
        """Inverse of slot(): the per-axis index of a flat slot."""
        out = []
        for a in reversed(self.axis_names):
            out.append(slot % self.shape[a])
            slot //= self.shape[a]
        return tuple(reversed(out))

    def device(self, *index: int):
        return self.devices[self.slot(*index)]

    def __repr__(self) -> str:
        axes = ", ".join(f"{a}={s}" for a, s in self.shape.items())
        return f"Mesh({axes}; {[str(d) for d in self.devices]})"


def set_local_devices(devices: Optional[Sequence]) -> None:
    """Install the local device list readers take (None: discover
    again).  The tests install 8 entries of `cpu`, the counterpart of
    the JAX package's 8 virtual CPU devices."""
    import torch

    global _LOCAL_DEVICES
    _LOCAL_DEVICES = (None if devices is None
                      else [torch.device(d) for d in devices])


@contextlib.contextmanager
def local_devices_scope(devices: Optional[Sequence]):
    """set_local_devices for the duration of a block, then restored."""
    global _LOCAL_DEVICES
    old = _LOCAL_DEVICES
    set_local_devices(devices)
    try:
        yield
    finally:
        _LOCAL_DEVICES = old


def local_devices(device="cuda") -> list:
    """The local devices of `device`'s type: the installed list when one
    of that type is installed, else every local card (`cuda`) or the one
    host device (`cpu`)."""
    import torch

    kind = torch.device(device).type
    if _LOCAL_DEVICES is not None and _LOCAL_DEVICES \
            and _LOCAL_DEVICES[0].type == kind:
        return list(_LOCAL_DEVICES)
    if kind == "cuda":
        ensure(torch.cuda.is_available(),
               "no CUDA device for a CUDA mesh (pass device='cpu' for a "
               "CPU run)")
        return [torch.device("cuda", i)
                for i in range(torch.cuda.device_count())]
    return [torch.device(kind)]


def segment_mesh(n_devices: Optional[int] = None,
                 devices: Optional[Sequence] = None) -> Mesh:
    """1-D mesh over the segment (time-window) axis: segments are
    embarrassingly parallel and only grid-sized aggregates cross the
    axis."""
    devs = list(devices) if devices is not None else local_devices()
    if n_devices is not None:
        ensure(len(devs) >= n_devices,
               f"requested a {n_devices}-device mesh but only "
               f"{len(devs)} devices are available")
        devs = devs[:n_devices]
    return Mesh(devs, (SEGMENT_AXIS,), (len(devs),))


def default_scan_shape(n_devices: int) -> tuple[int, int]:
    """Auto (time, series) factorization for `n` local devices: series
    gets 2 when it divides evenly past a 2x2 mesh, else 1 — the time
    axis (window parallelism) is where scan throughput scales, while
    the series axis only divides grid state and combine egress."""
    ensure(n_devices >= 1, "mesh needs at least one device")
    series = 2 if n_devices >= 4 and n_devices % 2 == 0 else 1
    return n_devices // series, series


def scan_mesh(time: int = 0, series: int = 0,
              devices: Optional[Sequence] = None) -> Mesh:
    """The 2-D (time, series) scan mesh ([scan.mesh]).

    `time`/`series` of 0 mean auto: use every listed device under
    default_scan_shape's factorization (one axis given → the other is
    derived).  `series` must be a power of two — group spaces are
    padded to powers of two and the series axis must divide them
    exactly."""
    devs = list(devices) if devices is not None else local_devices()
    n = len(devs)
    if time == 0 and series == 0:
        time, series = default_scan_shape(n)
    elif time == 0:
        ensure(series > 0 and n % series == 0,
               f"[scan.mesh] series = {series} does not divide the "
               f"{n} local devices")
        time = n // series
    elif series == 0:
        ensure(time > 0 and n % time == 0,
               f"[scan.mesh] time = {time} does not divide the "
               f"{n} local devices")
        series = n // time
    ensure(time * series <= n,
           f"[scan.mesh] {time}x{series} mesh needs {time * series} "
           f"devices but only {n} are available")
    ensure(series & (series - 1) == 0,
           f"[scan.mesh] series = {series} must be a power of two "
           "(group spaces are padded to powers of two and the series "
           "axis must divide them)")
    return Mesh(devs[: time * series], (TIME_AXIS, SERIES_AXIS),
                (time, series))
