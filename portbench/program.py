"""The benchmark's one contact with the program's configuration: the
port's ``ModelConfig`` for a configuration's file of sizes.

The file names the port's registered architecture (``port_arch``) and
which of its own keys each ``ModelConfig`` field takes
(``port_fields``); the family's file (``reference/<family>.py``,
``port_segments``) maps the file's layers to the port's segments. What
the file states is what runs.
"""

from __future__ import annotations

import dataclasses


def port_config(spec: dict):
    from repro_torch.configs import get_config

    from portbench.harness import family_module
    base = get_config(spec["port_arch"])
    fields = {f: spec[key] for f, key in spec["port_fields"].items()}
    fields["segments"] = family_module(spec["family"]).port_segments(spec,
                                                                     base)
    return dataclasses.replace(base, **fields)
