"""The port's ``ADFLOW`` against the JAX package's, class against class:

- the only JAX method with no port counterpart is
  ``_finalize_actuator_sources``, a no-op there that the port leaves out
  (its actuator energy row is evaluated in the residual);
- every public method the two share has the same signature;
- no option is refused as unported: several devices (``meshDevices > 1``)
  take the stacked route, and without a process group of that size they
  raise ``ValueError``.
"""

import inspect
import re

import pytest

from adflow_torch.api import solver as tsolver
from adflow_tpu.api.solver import ADFLOW as JaxADFLOW

NO_OP = {"_finalize_actuator_sources"}


def _methods(cls):
    return {n for n, v in inspect.getmembers(cls) if callable(v)}


def test_missing_methods_are_item_12():
    """Item 12's methods (``_solve_stacked``, ``checkPartitioning``) are
    ported; only the JAX package's no-op is left out."""
    missing = _methods(JaxADFLOW) - _methods(tsolver.ADFLOW)
    assert missing == NO_OP
    assert {"_solve_stacked", "checkPartitioning"} <= _methods(tsolver.ADFLOW)


@pytest.mark.parametrize(
    "name", sorted(n for n in _methods(JaxADFLOW) & _methods(tsolver.ADFLOW)
                   if not n.startswith("_")))
def test_shared_public_signatures(name):
    assert (inspect.signature(getattr(tsolver.ADFLOW, name))
            == inspect.signature(getattr(JaxADFLOW, name)))


def test_only_several_devices_refused():
    """Several devices need a process group of ``meshDevices`` ranks: with
    none, construction raises ``ValueError``; the port refuses nothing as
    unported any more."""
    from adflow_torch.meshgen.analytic import wing_omesh

    mesh = wing_omesh(ni=8, nj=4, nk=4)
    with pytest.raises(ValueError, match="meshDevices=2"):
        tsolver.ADFLOW(options={"meshDevices": 2}, mesh=mesh, device="cpu")
    tsolver.ADFLOW(options={"restartFile": "", "jaxProfileDir": ""},
                   mesh=mesh, device="cpu")
    src = inspect.getsource(tsolver)
    assert not re.search(r"_todo|_reject_unported_options|item 12", src)
