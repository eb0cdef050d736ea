"""The port's ``ADFLOW`` against the JAX package's, class against class:

- the JAX methods with no port counterpart are exactly the item-12 ones
  (several devices: ``_solve_stacked`` and ``checkPartitioning``) and
  ``_finalize_actuator_sources``, a no-op there that the port leaves out
  (its actuator energy row is evaluated in the residual);
- every public method the two share has the same signature;
- ``_reject_unported_options`` raises only for ``meshDevices > 1``, and
  every ``_todo`` left names item 12.
"""

import inspect
import re

import pytest

from adflow_torch.api import solver as tsolver
from adflow_tpu.api.solver import ADFLOW as JaxADFLOW

ITEM_12 = {"_solve_stacked", "checkPartitioning"}
NO_OP = {"_finalize_actuator_sources"}


def _methods(cls):
    return {n for n, v in inspect.getmembers(cls) if callable(v)}


def test_missing_methods_are_item_12():
    missing = _methods(JaxADFLOW) - _methods(tsolver.ADFLOW)
    assert missing == ITEM_12 | NO_OP


@pytest.mark.parametrize(
    "name", sorted(n for n in _methods(JaxADFLOW) & _methods(tsolver.ADFLOW)
                   if not n.startswith("_")))
def test_shared_public_signatures(name):
    assert (inspect.signature(getattr(tsolver.ADFLOW, name))
            == inspect.signature(getattr(JaxADFLOW, name)))


def test_only_several_devices_refused():
    from adflow_torch.meshgen.analytic import wing_omesh

    mesh = wing_omesh(ni=8, nj=4, nk=4)
    with pytest.raises(NotImplementedError, match="item 12"):
        tsolver.ADFLOW(options={"meshDevices": 2}, mesh=mesh, device="cpu")
    tsolver.ADFLOW(options={"restartFile": "", "jaxProfileDir": ""},
                   mesh=mesh, device="cpu")
    src = inspect.getsource(tsolver)
    items = re.findall(r'_todo\([^)]*?"(\d+)"\)', src, re.S)
    assert items and set(items) == {"12"}
