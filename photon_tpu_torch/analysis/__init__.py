"""Static analysis of the port (port of ``photon_tpu/analysis``).

Ported so far:

- the cost model (``costmodel``): the H100's peaks, the kernels' work
  counts, and ``collective_transfer``, which prices a census of
  collectives;
- the framework core and reporters (``core``, ``report``): findings,
  per-line suppressions (``# photon: ignore[rule] -- reason``), the rule
  registry;
- the SPMD tier (``spmd``; ``--spmd``): the ranks' censuses of
  collectives held against each other and against the mesh's declared
  ``SPMD_AUDIT``, partition-rule coverage, and the host-divergence lint.

The reference's other tiers (tier-1 rules, ``--semantic``,
``--concurrency``, ``--memory``, ``--numerics``) are ROADMAP Queue A
item 13's later parts; their CLI flags raise naming it.

Usage::

    python -m photon_tpu_torch.analysis --spmd [--hosts N] [--json]
    python -m photon_tpu_torch.analysis --spmd --list-rules
"""

from photon_tpu_torch.analysis.core import (
    Finding,
    ModuleContext,
    Rule,
    analyze_file,
    analyze_paths,
    analyze_source,
    registered_rules,
    rule,
)
from photon_tpu_torch.analysis.report import (
    render_json,
    render_rule_list,
    render_text,
    summarize,
)

__all__ = [
    "Finding",
    "ModuleContext",
    "Rule",
    "analyze_file",
    "analyze_paths",
    "analyze_source",
    "registered_rules",
    "rule",
    "render_json",
    "render_rule_list",
    "render_text",
    "summarize",
]
