"""Devices of a multi-device count (the port's kmc_tpu/parallel/distributed.py).

kmc_tpu builds a jax.sharding.Mesh; the port takes a plain list of
torch.devices, one per shard of the store.  A list may repeat a device, so
one card (or the CPU) can hold several shards: ["cuda:0"] * 4 is the
counterpart of the 8-virtual-device CPU mesh that kmc_tpu's tests use.
"""
from __future__ import annotations

import torch

from ..device import resolve_device


def make_mesh(n_devices: int | None = None, device="cuda") -> list:
    """The shards' devices (mirrors kmc_tpu's make_mesh).

    device="cuda" (default): every visible card, or the first n_devices of
    them; raises RuntimeError when there is no card or fewer than
    n_devices, and never falls back to the CPU.  device="cpu": n_devices
    (default 1) shards on the CPU, which the caller asks for explicitly."""
    kind = torch.device(device).type
    if kind == "cpu":
        return [resolve_device("cpu")] * (1 if n_devices is None
                                           else int(n_devices))
    resolve_device(device)  # raises without a card
    n_cards = torch.cuda.device_count()
    n = n_cards if n_devices is None else int(n_devices)
    if n < 1 or n > n_cards:
        raise RuntimeError(f"kmc_tpu_torch: {n} CUDA devices asked for, "
                           f"{n_cards} visible")
    return [torch.device("cuda", i) for i in range(n)]


def resolve_devices(devices) -> list:
    """torch.devices for a caller's list (None: make_mesh()); each entry
    is one shard, and entries may repeat."""
    if devices is None:
        return make_mesh()
    out = [resolve_device(d) for d in devices]
    if not out:
        raise ValueError("need at least one device")
    return out
