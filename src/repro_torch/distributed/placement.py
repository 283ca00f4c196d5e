"""Per-replica device placement (cluster scale-out) of the PyTorch port,
as ``repro.distributed.placement`` (whose module imports JAX).

A deployment runs one device per model replica; a front end then
overlaps the replicas' compute, not only their swap transfers.  Placement
stays thin: move a replica's parameters to its device with
:func:`place_params` and build its engine (KV pool, prefix cache, warmup
captures) under :func:`device_scope`, so that the tensors it creates
without naming a device land there.  Replicas that share a device share
one copy of the weights: :func:`place_params` returns the tensors that
already live on the target device as they are.

Devices are ``torch.device`` objects, labelled ``cuda:0`` or ``cpu:0``.
"""
from __future__ import annotations

import contextlib
from typing import List, Sequence, Union

import torch

DeviceSpec = Union[None, str, Sequence]


def _norm(dev) -> torch.device:
    """``dev`` as the device a tensor on it reports (the CPU has no
    index; a CUDA device without one is the current device)."""
    dev = torch.device(dev)
    if dev.type == "cpu":
        return torch.device("cpu")
    if dev.type == "cuda" and dev.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return dev


def device_label(dev) -> str:
    """Stable ``type:index`` label (``cuda:0``; ``cpu:0`` for the CPU)
    used for replica attribution in gauges and in ``--devices`` specs."""
    dev = torch.device(dev)
    return f"{dev.type}:{dev.index or 0}"


def _all_devices() -> List[torch.device]:
    """Every CUDA device, else the CPU."""
    if torch.cuda.is_available():
        return [torch.device("cuda", i)
                for i in range(torch.cuda.device_count())]
    return [torch.device("cpu")]


def default_device_label() -> str:
    return device_label(_all_devices()[0])


def available_devices(spec: DeviceSpec = None) -> List[torch.device]:
    """Resolve a device spec to a list of torch devices.

    ``None`` / ``"auto"``: every CUDA device (an error where there is
    none).  ``"cpu"`` / ``"cuda"``: every device of that type.
    ``"cuda:0,cuda:1"`` or ``"0,1"``: explicit devices by label or by
    index into the list of every device.  A sequence of devices passes
    through.
    """
    if spec is None or spec in ("auto", ""):
        if not torch.cuda.is_available():
            raise ValueError("device spec 'auto' needs a CUDA device; ask "
                             "for 'cpu' to place replicas on the CPU")
        return _all_devices()
    if not isinstance(spec, str):
        return [_norm(d) for d in spec]
    devs = _all_devices()
    by_type = {"cpu": [torch.device("cpu")]}
    if torch.cuda.is_available():
        by_type["cuda"] = [d for d in devs if d.type == "cuda"]
    by_label = {device_label(d): d for ds in by_type.values() for d in ds}
    picked = []
    for part in spec.split(","):
        part = part.strip()
        if not part:
            continue
        if part in by_label:
            picked.append(by_label[part])
        elif part.isdigit():
            if int(part) >= len(devs):
                raise ValueError(f"device index {part} out of range "
                                 f"(have {len(devs)} devices)")
            picked.append(devs[int(part)])
        elif part in by_type:
            picked.extend(by_type[part])
        else:
            raise ValueError(f"no devices match {part!r} "
                             f"(have {sorted(by_label)})")
    if not picked:
        raise ValueError(f"device spec {spec!r} selected no devices")
    return picked


def assign_devices(n_replicas: int, spec: DeviceSpec = None
                   ) -> List[torch.device]:
    """Round-robin ``n_replicas`` over the resolved device list (replica
    ``i`` -> ``devices[i % len(devices)]``); with one device every
    replica shares it."""
    devs = available_devices(spec)
    return [devs[i % len(devs)] for i in range(n_replicas)]


def place_params(params, device):
    """Move a parameter tree (nested dicts and lists of tensors) to
    ``device`` with ``.to(device)`` per tensor.  A tensor already on
    ``device`` comes back as the same object, so replicas that share a
    device share one copy of the weights."""
    if device is None:
        return params
    device = _norm(device)
    if isinstance(params, dict):
        return {k: place_params(v, device) for k, v in params.items()}
    if isinstance(params, (list, tuple)):
        return type(params)(place_params(v, device) for v in params)
    if isinstance(params, torch.Tensor):
        return params.to(device)
    return params


def device_scope(device):
    """Context manager: tensors created inside without a device default
    to ``device`` (a null context for None).  Engine construction and
    warmup run under it, so that the KV pool and the prefix store live
    with the replica's parameters."""
    if device is None:
        return contextlib.nullcontext()
    return _norm(device)
