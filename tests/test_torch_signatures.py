"""PyTorch port, signature parity: every public function and class that a
module of the JAX package defines has a counterpart of the same name in
the same module of hagrid_tpu_torch, and the counterpart takes every
parameter name of the reference (functions, constructors and the public
methods a class defines itself). The port may add parameters; a `*args`
or `**kwargs` parameter is matched by its kind, not its name. The
exemptions below are the documented ones, each with its reason.
"""

import importlib
import inspect
import pkgutil

import pytest

import hagrid_tpu

# (module, name) -> (parameters the port does not take, why).
KEY = "a jax.random key; the port draws from a torch.Generator"
EXEMPT_PARAMS = {
    ("hagrid_tpu.ops.sweep_trace", "trace_sweep"): (
        {"interpret", "dma"},
        "Pallas interpret mode and its XLA-gather switch exist only for "
        "the TPU kernel (ROADMAP 'Not to port')"),
    ("hagrid_tpu.render.integrators", "ambient_occlusion"): ({"key"}, KEY),
    ("hagrid_tpu.render.sampling", "cosine_hemisphere"): ({"key"}, KEY),
    ("hagrid_tpu.parallel.distributed", "initialize"): (
        {"coordinator_address", "num_processes", "process_id"},
        "jax.distributed's arguments; the port takes torch.distributed's "
        "init_method, world_size and rank"),
    ("hagrid_tpu.parallel.distributed", "global_mesh"): (
        {"axis"},
        "the axis name of a jax.sharding.Mesh; the port's mesh is a tuple "
        "of devices"),
    ("hagrid_tpu.utils.profiling", "device_trace"): (
        {"log_dir"},
        "jax.profiler's trace directory; the port writes torch.profiler's "
        "Chrome trace to `path`"),
}
# Reference names with no counterpart, and why.
EXEMPT_MISSING = {
    ("hagrid_tpu.native.objloader_native", "try_load"):
        "the fall-back to the Python parser: in the port a failed native "
        "build raises",
    ("hagrid_tpu.utils.cache", None):
        "JAX's persistent compile cache; PyTorch compiles nothing ahead",
}


def _reference_modules():
    """Every Python module of the JAX package (the native parser's shared
    library is not one)."""
    names = ["hagrid_tpu"]
    for m in pkgutil.walk_packages(hagrid_tpu.__path__, "hagrid_tpu."):
        spec = importlib.util.find_spec(m.name)
        if spec.origin and spec.origin.endswith(".py"):
            names.append(m.name)
    return names


def _public(module):
    """(name, object) of each public function and class the module
    defines itself."""
    for name, obj in sorted(vars(module).items()):
        if name.startswith("_") or not (inspect.isfunction(obj)
                                        or inspect.isclass(obj)):
            continue
        if obj.__module__ == module.__name__:
            yield name, obj


def _methods(cls):
    """The public methods the class defines itself (not those a dataclass
    decorator or a base class adds)."""
    for name, attr in vars(cls).items():
        fn = attr.__func__ if isinstance(attr, (staticmethod,
                                                classmethod)) else attr
        if (not name.startswith("_") and inspect.isfunction(fn)
                and fn.__module__ == cls.__module__):
            yield name, fn


def _missing_params(ref, port):
    """The reference's parameters the port's callable does not take."""
    want = inspect.signature(ref).parameters.values()
    have = inspect.signature(port).parameters.values()
    names = {p.name for p in have}
    kinds = {p.kind for p in have}
    out = set()
    for p in want:
        if p.kind in (p.VAR_POSITIONAL, p.VAR_KEYWORD):
            if p.kind not in kinds:
                out.add(p.name)
        elif p.name not in names:
            out.add(p.name)
    return out


def _gaps():
    """Every unexempted gap: ("missing", where) or ("params", where,
    sorted parameters)."""
    gaps = []
    for mod_name in _reference_modules():
        if (mod_name, None) in EXEMPT_MISSING:
            continue
        ref_mod = importlib.import_module(mod_name)
        port_mod = importlib.import_module(
            mod_name.replace("hagrid_tpu", "hagrid_tpu_torch", 1))
        for name, ref in _public(ref_mod):
            port = getattr(port_mod, name, None)
            if port is None:
                if (mod_name, name) not in EXEMPT_MISSING:
                    gaps.append(("missing", f"{mod_name}.{name}"))
                continue
            pairs = [(name, ref, port)]
            if inspect.isclass(ref):
                for mname, fn in _methods(ref):
                    pfn = getattr(port, mname, None)
                    if pfn is None:
                        gaps.append(("missing", f"{mod_name}.{name}.{mname}"))
                    else:
                        pairs.append((f"{name}.{mname}", fn, pfn))
            for qual, r, p in pairs:
                miss = _missing_params(r, p)
                miss -= EXEMPT_PARAMS.get((mod_name, qual), (set(), ""))[0]
                if miss:
                    gaps.append(("params", f"{mod_name}.{qual}",
                                 sorted(miss)))
    return gaps


def test_port_takes_every_reference_parameter():
    gaps = _gaps()
    assert not gaps, f"the port lacks what the reference has: {gaps}"


def test_exemptions_are_still_needed():
    """Each exemption names a gap that exists: a parameter that the port
    does not take, or a name that it does not have."""
    for (mod_name, name), (params, why) in EXEMPT_PARAMS.items():
        assert why
        ref = getattr(importlib.import_module(mod_name), name)
        port = getattr(importlib.import_module(
            mod_name.replace("hagrid_tpu", "hagrid_tpu_torch", 1)), name)
        assert _missing_params(ref, port) == params, (mod_name, name)
    for (mod_name, name), why in EXEMPT_MISSING.items():
        assert why
        port_name = mod_name.replace("hagrid_tpu", "hagrid_tpu_torch", 1)
        if name is None:
            assert importlib.util.find_spec(port_name) is None
        else:
            assert hasattr(importlib.import_module(mod_name), name)
            assert not hasattr(importlib.import_module(port_name), name)


@pytest.mark.parametrize("where,name,default", [
    ("ops.sweep_trace", "trace_sweep", "compact"),
    ("ops.sweep_trace", "trace_sweep", "fine_bins"),
    ("render.integrators", "trace_sorted", "sort"),
    ("render.integrators", "ambient_occlusion", "max_dist"),
    ("render.integrators", "ambient_occlusion", "n_samples"),
    ("render.integrators", "path_trace", "sky"),
    ("render.integrators", "path_trace", "albedo"),
    ("grid.irregular", "trace_irregular", "refs_per_iter"),
    ("grid.uniform", "trace_uniform", "refs_per_iter"),
])
def test_restored_options_keep_the_reference_defaults(where, name, default):
    ref = getattr(importlib.import_module(f"hagrid_tpu.{where}"), name)
    port = getattr(importlib.import_module(f"hagrid_tpu_torch.{where}"),
                   name)
    want = inspect.signature(ref).parameters[default].default
    got = inspect.signature(port).parameters[default].default
    assert got == want and type(got) is type(want)
