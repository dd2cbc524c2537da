"""What the benchmark takes from the program (``fourk_nerf_torch``): a model
family's module and its configuration object built from a configuration
file, and the kernels' launch counters. Imported only inside a run: the
program is not present in a checkout that holds the benchmark alone.
"""

from __future__ import annotations

import importlib
import pkgutil

from portbench.reference import common as C


def model_module(cfg: dict):
    """The program's module of the configuration's family
    (``fourk_nerf_torch.models.<family>``)."""
    return importlib.import_module(f"fourk_nerf_torch.models.{cfg['family']}")


def model_config(cfg: dict):
    """The program's static model description of the configuration, from
    the family's ``make_config`` and the configuration's ``model`` keys
    (``make_config`` takes the fields it knows); its world size is held to
    the reference's."""
    pc = model_module(cfg).make_config(**cfg["model"])
    want = C.world_size(cfg["family"], cfg["model"])
    if tuple(pc.world_size) != tuple(want):
        raise RuntimeError(f"the program's world size {pc.world_size} is "
                           f"not the configuration's {want}")
    return pc


def counters() -> dict:
    """Every kernel wrapper with a launch counter, by ``<module>.<name>``:
    the module-level functions with a ``launches`` attribute in the
    program's ``ops/cuda_*.py`` modules."""
    from fourk_nerf_torch import ops
    out = {}
    for info in pkgutil.iter_modules(ops.__path__):
        if not info.name.startswith("cuda_"):
            continue
        mod = importlib.import_module(f"fourk_nerf_torch.ops.{info.name}")
        for name, fn in vars(mod).items():
            if callable(fn) and isinstance(getattr(fn, "launches", None), int):
                out[f"{info.name}.{name}"] = fn
    return out


def launches() -> dict:
    return {k: fn.launches for k, fn in counters().items()}
