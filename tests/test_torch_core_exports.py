"""`repro_torch.core` re-exports what `repro.core` does: every public name
of the reference's package (its submodules and its 35 functions, classes
and constants) is an attribute of the port's, and it is the port's own
object: a submodule of `repro_torch.core`, or the object of that name in
the port's submodule that defines the reference's."""
import types

import pytest

pytest.importorskip("torch")

import repro.core as R  # noqa: E402
import repro_torch.core as T  # noqa: E402

import _torch_helpers  # noqa: E402,F401  (one torch thread a worker)

NAMES = sorted(n for n in dir(R) if not n.startswith("_"))


@pytest.mark.parametrize("name", NAMES)
def test_every_public_name_of_repro_core_is_the_ports_own(name):
    ref = getattr(R, name)
    got = getattr(T, name)
    if isinstance(ref, types.ModuleType):
        assert got.__name__ == "repro_torch.core." + name
        return
    home = getattr(ref, "__module__", None) or f"repro.core.{name}"
    if not isinstance(ref, (type, types.FunctionType)):
        home = next(f"repro.core.{m}" for m in dir(R) if isinstance(
            getattr(R, m), types.ModuleType) and getattr(getattr(R, m),
                                                         name, None) is ref)
    port_mod = __import__("repro_torch.core." + home.rsplit(".", 1)[1],
                          fromlist=["_"])
    assert got is getattr(port_mod, name)
    assert type(got).__module__.split(".")[0] != "repro"
    if isinstance(got, (type, types.FunctionType)):
        assert got.__module__.startswith("repro_torch.core.")


def test_the_quickstart_imports():
    from repro_torch.core import (AcamFunction, bit_sliced_matmul,  # noqa
                                  raceit_attention)
    assert callable(bit_sliced_matmul) and callable(raceit_attention)
