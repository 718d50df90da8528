"""The Conformer modules' rooflines from a traced slice: the least time of
a step's calls of a module (`conformer_flops.module_least_s`) over the
device time a step of the records launched in its spans,
`rnnt.conformer.<module>` and `rnnt.conformer.<module>.bwd`
(`benchlib.spans.digest`'s `device_span`)."""

from __future__ import annotations

from typing import Optional

from benchlib.conformer_flops import module_least_s

PREFIX = "rnnt.conformer."


def module_device_s(profile: Optional[dict], module: str, steps: int
                    ) -> Optional[float]:
    """Device seconds a step of the records in the module's two spans;
    None without `device_span` or with no such record."""
    if not profile or "device_span" not in profile:
        return None
    names = (PREFIX + module, PREFIX + module + ".bwd")
    us = sum(e - s for (_, s, e), span in zip(profile["device"],
                                              profile["device_span"])
             if span in names)
    return us / 1e6 / steps if us > 0 else None


def roofline(run, module: str) -> Optional[float]:
    """The module's share of its roofline in percent, or None."""
    if run.m.get("encoder_type") != "conformer":
        return None
    t = module_device_s(run.profile, module, run.traffic["profile_steps"])
    if t is None:
        return None
    B, T, _ = run.batch
    return 100.0 * module_least_s(module, run.m, B, T) / t
