"""Device meshes of the sharded training path (port of
``repro/launch/mesh.py``).

Functions, never module-level state: importing this module touches no
process group.  ``make_production_mesh`` is the reference's production
layout, (data=16, model=16), or with a leading ``pod`` axis (2, 16, 16);
``make_test_mesh`` a small one.  Both build a ``DeviceMesh`` with
``init_device_mesh`` over the process group this process joined
(``launch/_host_devices.py``, or the dry run's ``launch/fake_group.py``),
whose world size must equal the mesh's.  ``device_type`` names the mesh's
device where the group does not (a fake group's ranks hold the device the
dry run fakes); by default it follows the backend.
"""
from __future__ import annotations


def _device_type() -> str:
    import torch.distributed as dist

    return "cuda" if dist.get_backend() == "nccl" else "cpu"


def make_production_mesh(*, multi_pod: bool = False, device_type: str | None = None):
    from torch.distributed.device_mesh import init_device_mesh

    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return init_device_mesh(device_type or _device_type(), shape, mesh_dim_names=axes)


def make_test_mesh(shape=(2, 2), axes=("data", "model"), device_type: str | None = None):
    """A small mesh over this process group (gloo ranks on the CPU, NCCL
    ranks on cards)."""
    from torch.distributed.device_mesh import init_device_mesh

    return init_device_mesh(device_type or _device_type(), tuple(shape),
                            mesh_dim_names=tuple(axes))


def parse_mesh(text: str) -> tuple[int, int]:
    """``"dxm"`` -> (d, m), the (data, model) shape of ``--mesh``."""
    try:
        d, m = (int(x) for x in text.lower().split("x"))
    except ValueError:
        raise ValueError(f"--mesh takes DATAxMODEL, such as 2x2, not {text!r}") from None
    if d < 1 or m < 1:
        raise ValueError(f"--mesh {text}: both sizes must be at least 1")
    return d, m
