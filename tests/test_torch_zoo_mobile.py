"""mobilenet_v2 and efficientnet_b0 of the port against the JAX package's
modules on the CPU: the checks, sizes and tolerances of
``test_torch_zoo_models.py`` (a file of their own so that loadfile places
them on another worker). efficientnet's stochastic depth is off on the
JAX side through its ``_DROP_PATH_RATE`` (``monkeypatch``) and on the
port's through ``drop_path_rate=0``; dropout through the constructors.
"""

import sys

import pytest

from test_torch_zoo_models import JaxEfficientNetB0, check_against_jax, no_tf32  # noqa: F401


@pytest.mark.parametrize("arch", ["mobilenet_v2", "efficientnet_b0"])
def test_forwards_stats_and_gradients_match_jax(arch, monkeypatch):
    monkeypatch.setattr(sys.modules[JaxEfficientNetB0.__module__], "_DROP_PATH_RATE", 0.0)
    check_against_jax(arch)
