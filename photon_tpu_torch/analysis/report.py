"""Finding reporters: human text and machine JSON (port of
``photon_tpu/analysis/report.py``)."""

from __future__ import annotations

import json
from typing import Iterable

from photon_tpu_torch.analysis.core import Finding, registered_rules


def summarize(findings: Iterable[Finding]) -> dict:
    findings = list(findings)
    active = [f for f in findings if not f.suppressed]
    by_rule: dict[str, int] = {}
    for f in active:
        by_rule[f.rule] = by_rule.get(f.rule, 0) + 1
    return {
        "total": len(findings),
        "unsuppressed": len(active),
        "suppressed": len(findings) - len(active),
        "by_rule": dict(sorted(by_rule.items())),
    }


def render_text(
    findings: list[Finding], show_suppressed: bool = False
) -> str:
    lines = [
        f.format()
        for f in findings
        if show_suppressed or not f.suppressed
    ]
    s = summarize(findings)
    tail = (
        f"{s['unsuppressed']} finding(s), {s['suppressed']} suppressed"
    )
    if s["by_rule"]:
        tail += " [" + ", ".join(
            f"{k}: {v}" for k, v in s["by_rule"].items()
        ) + "]"
    lines.append(tail)
    return "\n".join(lines)


def render_json(findings: list[Finding]) -> str:
    return json.dumps(
        {
            "findings": [f.to_json() for f in findings],
            "summary": summarize(findings),
        },
        indent=2,
    )


def render_rule_list() -> str:
    rules = registered_rules()
    if not rules:
        return "no tier-1 rules are ported (ROADMAP Queue A item 13)"
    width = max(len(r) for r in rules)
    return "\n".join(
        f"{r.id.ljust(width)}  {r.summary}" for r in rules.values()
    )
