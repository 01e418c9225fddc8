"""The device mesh that the wave engine's walks split their rows over.

A ``Mesh`` holds dp x sp devices, row-major over (dp, sp).  Its
``split(n)`` gives contiguous row ranges, one a device, so the row order
is kept and the STRIPE sub-streams that the wave driver lays out next
to each other land on neighbouring devices (the sp axis).  A device may
stand in a mesh more than once; its ranges then run one after another
on it.  Wherever the port takes a ``torch.device`` it takes a ``Mesh``
too, and a one-device mesh behaves exactly as its device.

This module imports only torch, so that the kernel layer (``ops``) and
the engine can take a mesh without depending on ``parallel``, which
imports them.
"""

from __future__ import annotations

import torch


class Mesh:
    """dp x sp devices, row-major over (dp, sp)."""

    def __init__(self, devices, dp: int, sp: int):
        devices = tuple(torch.device(d) for d in devices)
        if dp < 1 or sp < 1 or len(devices) != dp * sp:
            raise ValueError(f"a {dp}x{sp} mesh needs {dp * sp} devices, "
                             f"{len(devices)} given")
        self.devices = devices
        self.dp = dp
        self.sp = sp
        self.size = dp * sp

    def split(self, n: int) -> list[tuple[torch.device, int, int]]:
        """[(device, lo, hi), ...]: contiguous ranges of ceil(n / size)
        rows in device order, the last one shorter, empty ones dropped."""
        per = -(-n // self.size)
        out = []
        for k, dev in enumerate(self.devices):
            lo, hi = k * per, min((k + 1) * per, n)
            if lo < hi:
                out.append((dev, lo, hi))
        return out

    def __repr__(self) -> str:
        return (f"Mesh({self.dp}x{self.sp}, "
                f"{[str(d) for d in self.devices]})")


def make_mesh(devices=None, dp: int | None = None, sp: int = 1) -> Mesh:
    """A dp x sp mesh of the first dp * sp of `devices` (default: every
    visible CUDA device); dp defaults to len(devices) // sp."""
    if devices is None:
        devices = [torch.device("cuda", i)
                   for i in range(torch.cuda.device_count())]
    devices = list(devices)
    if dp is None:
        dp = len(devices) // sp
    if dp < 1 or dp * sp > len(devices):
        raise ValueError(f"a {dp}x{sp} mesh needs {max(dp, 1) * sp} "
                         f"devices, {len(devices)} given")
    return Mesh(devices[:dp * sp], dp, sp)


def as_mesh(device) -> Mesh:
    """`device` itself if it is a Mesh, else a one-device mesh of it."""
    return device if isinstance(device, Mesh) else Mesh((device,), 1, 1)


def split_rows(device, n: int) -> list[tuple[torch.device, int, int]]:
    """Row ranges of n rows over a device or a mesh (Mesh.split)."""
    return as_mesh(device).split(n)


def first_device(device) -> torch.device:
    """The device of a single-device call; a mesh's first device."""
    return as_mesh(device).devices[0]
