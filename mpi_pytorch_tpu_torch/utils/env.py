"""Boolean ``MPT_*`` env-knob parsing — one definition of truthiness,
the same falsy set as the JAX package's ``utils/env.py``: case-insensitive
'', '0', 'false', 'no' and 'off' mean off, anything else means on."""

from __future__ import annotations

import os

FALSY = ("", "0", "false", "no", "off")


def env_flag(name: str, default: bool = False) -> bool:
    """The value of boolean env knob ``name``; ``default`` when unset."""
    raw = os.environ.get(name)
    if raw is None:
        return default
    return raw.lower() not in FALSY
