"""What the tests of the port's examples share (``tests/test_torch_examples
*.py``): the reference's example modules, and the tolerance of the losses
and grad norms (the parameters' is ``_train.py``'s).
"""
import importlib.util
import os

ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), os.pardir))
CPU = ["--device", "cpu"]


def _reference(name):
    """The reference's ``examples/<name>.py`` as a module."""
    spec = importlib.util.spec_from_file_location(
        f"_reference_example_{name}", os.path.join(ROOT, "examples",
                                                   f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _metrics_close(got, want):
    """Loss within 1e-4, grad norm within 1e-4 relative, step for step."""
    assert len(got) == len(want)
    for (gl, gn), (wl, wn) in zip(got, want):
        assert abs(gl - wl) <= 1e-4
        assert abs(gn - wn) <= 1e-4 * wn
