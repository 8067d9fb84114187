"""Helpers of the examples' tests (``tests/test_torch_example_*.py``): the
reference's example scripts loaded from ``examples/`` as modules, and the
reference's ``PRNGKey(0)`` parameters converted for the port."""
import importlib.util
import pathlib

import numpy as np

ROOT = pathlib.Path(__file__).resolve().parents[1]
PRINTED_4 = 5e-5  # a loss printed with 4 decimals is within half a unit of the last digit


def reference_example(name: str):
    """``examples/<name>.py`` of the reference as a module (never
    ``geo_train``: importing it sets ``XLA_FLAGS`` in this process)."""
    assert name != "geo_train"
    spec = importlib.util.spec_from_file_location(f"reference_example_{name}", ROOT / "examples" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def converted(ref_model, cfg):
    """``ref_model.init(PRNGKey(0))`` (the reference's own parameters) and
    the same as the port's parameters on the CPU."""
    import jax

    from repro_torch.convert import from_reference

    ref_params = ref_model.init(jax.random.PRNGKey(0))
    return ref_params, from_reference(jax.tree.map(np.asarray, ref_params), cfg)


def printed_losses(out: str, marker: str = "loss") -> list:
    """The numbers after ``marker`` on the lines that start with ``step``."""
    return [float(line.split(marker)[1].split()[0]) for line in out.splitlines() if line.lstrip().startswith("step")]
