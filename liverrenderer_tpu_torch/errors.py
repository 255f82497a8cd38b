"""The one error every not-yet-ported plugin or feature raises.

The port follows ROADMAP.md slice by slice; a scene that reaches code the
current slice does not carry fails loudly with the ROADMAP item that will
bring it, never silently renders something else.
"""
from __future__ import annotations


def not_ported(what: str, item: str) -> NotImplementedError:
    """`raise not_ported("the envmap emitter", "Queue 1 M5")`."""
    return NotImplementedError(
        f"{what} is not ported to liverrenderer_tpu_torch yet "
        f"(ROADMAP.md {item})")
