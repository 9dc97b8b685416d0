"""Finding model, suppression comments, and the checked-in baseline.

A ``Finding`` is one report from either engine (the AST engine,
:mod:`.ast_checks`, and the host-concurrency engine,
:mod:`.concurrency_checks`). Its ``key`` deliberately excludes the line
number: the baseline must survive unrelated edits above a grandfathered
finding, so identity is (check, path, symbol) plus an occurrence counter
handled by the baseline diff (two findings of the same check in the same
function count as two baseline slots).

Suppression, the same syntax as ``apex_tpu.analysis``'s, so the sources
of both packages read alike:

    x = float(loss)  # apex-lint: disable=host-in-jit
    # apex-lint: disable=sync-timing        <- or on the line above

``# apex-lint: disable`` with no ids suppresses every check on that line.

The baseline file and the snippet fingerprints are the reference's
format: a baseline written by either package loads in the other to the
same ``Counter``, and a finding has the same fingerprint in both.
"""

from __future__ import annotations

import collections
import dataclasses
import hashlib
import json
import os
import re

SEVERITIES = ("error", "warning")

_SUPPRESS_RE = re.compile(
    r"#\s*apex-lint:\s*disable(?:=([a-z0-9_,\- ]+))?", re.IGNORECASE)


@dataclasses.dataclass(frozen=True)
class Finding:
    check: str        # check id, e.g. "sync-timing"
    severity: str     # "error" | "warning"
    path: str         # repo-relative source path
    line: int         # 1-based source line; 0 when not source-mapped
    symbol: str       # enclosing function / analysis-target name
    message: str

    @property
    def key(self) -> str:
        return f"{self.check}:{self.path}:{self.symbol}"

    def render(self) -> str:
        loc = f"{self.path}:{self.line}" if self.line else self.path
        return f"{loc}: [{self.severity}] {self.check}: {self.message}" \
               f" (in {self.symbol})"


def suppressed_checks(source_lines, lineno: int):
    """Check ids suppressed at 1-based ``lineno`` (same line, or a
    comment-ONLY line directly above — a trailing comment on the
    previous code line suppresses that line, not this one). Returns
    None for "none", or a set; the empty set means ALL."""
    ids = None
    for ln in (lineno, lineno - 1):
        if not 1 <= ln <= len(source_lines):
            continue
        text = source_lines[ln - 1]
        if ln != lineno and not text.lstrip().startswith("#"):
            continue
        m = _SUPPRESS_RE.search(text)
        if m:
            named = m.group(1)
            if not named:
                return set()   # bare disable: everything
            ids = (ids or set()) | {
                s.strip() for s in named.split(",") if s.strip()}
    return ids


def is_suppressed(finding: Finding, source_lines) -> bool:
    ids = suppressed_checks(source_lines, finding.line)
    if ids is None:
        return False
    return not ids or finding.check in ids


# ------------------------------------------------------------- baseline

def load_baseline(path) -> collections.Counter:
    """Baseline file -> Counter of grandfathered finding keys."""
    with open(path) as f:
        data = json.load(f)
    return collections.Counter(data.get("grandfathered", {}))


def save_baseline(path, findings) -> None:
    counts = collections.Counter(f.key for f in findings)
    with open(path, "w") as f:
        json.dump({
            "_comment": (
                "apex_tpu_torch.analysis grandfathered findings. Keys "
                "are check:path:symbol; values are allowed occurrence "
                "counts. Regenerate with: python -m apex_tpu_torch.analysis "
                "--write-baseline <this file>. Shrink it, never grow it."),
            "grandfathered": dict(sorted(counts.items())),
        }, f, indent=2, sort_keys=False)
        f.write("\n")


def new_findings(findings, baseline: collections.Counter):
    """Findings not covered by the baseline (multiplicity-aware)."""
    budget = collections.Counter(baseline)
    fresh = []
    for f in findings:
        if budget[f.key] > 0:
            budget[f.key] -= 1
        else:
            fresh.append(f)
    return fresh


# --------------------------------------------------- snippet fingerprint
#
# A Finding's key embeds its PATH, so renaming/moving a file makes every
# grandfathered finding in it look NEW to `--diff` (the base dump's keys
# all name the old path). The fingerprint is the path-free identity:
# check + symbol + the flagged source LINE's text (whitespace-stripped).
# `--diff` falls back to it when the path:symbol key misses, so a pure
# rename/move never fails the gate while a genuinely new occurrence
# (different code, or one MORE of the same snippet than the base had —
# multiplicity-aware both ways) still does. Only source-mapped findings
# (line > 0) get one.


def finding_fingerprint(finding: Finding, root=None, lines_cache=None):
    """Stable ``check:symbol:snippet`` hash for a source-mapped finding,
    or None when the source line cannot be read (line 0, deleted
    files). ``lines_cache``: optional per-RUN dict (path ->
    line list or None) so N findings in one file cost one read; scope
    it to a single invocation — never across runs, files get rewritten
    between them."""
    if finding.line <= 0:
        return None
    path = finding.path
    if root is not None and not os.path.isabs(path):
        path = os.path.join(root, path)
    lines = lines_cache.get(path) if lines_cache is not None else None
    if lines is None:
        try:
            with open(path, encoding="utf-8") as f:
                lines = f.read().splitlines()
        except (OSError, UnicodeDecodeError):
            lines = []
        if lines_cache is not None:
            lines_cache[path] = lines
    try:
        snippet = lines[finding.line - 1].strip()
    except IndexError:
        return None
    digest = hashlib.sha1(
        f"{finding.check}:{finding.symbol}:{snippet}".encode()
    ).hexdigest()
    return digest[:16]


def new_findings_with_fingerprints(findings, baseline, base_fps,
                                   root=None):
    """:func:`new_findings`, with a second chance for findings whose
    path-keyed identity missed but whose snippet fingerprint is in the
    base run (``base_fps``: Counter of fingerprints) — the
    renamed/moved-file case."""
    budget = collections.Counter(baseline)
    fp_budget = collections.Counter(base_fps or {})
    lines_cache: dict = {}

    def fp_of(f):
        return finding_fingerprint(f, root=root,
                                   lines_cache=lines_cache) \
            if fp_budget else None

    # Two passes, NOT one: every path-keyed match must land (and
    # consume its fingerprint slot — a copy-paste duplicate may not
    # ride the renamed-file budget) BEFORE any fallback matching, or
    # the verdict depends on finding order (a duplicate whose path
    # sorts before the original would steal the fingerprint slot and
    # be silently grandfathered).
    unmatched = []
    for f in findings:
        if budget[f.key] > 0:
            budget[f.key] -= 1
            fp = fp_of(f)
            if fp is not None and fp_budget[fp] > 0:
                fp_budget[fp] -= 1
        else:
            unmatched.append(f)
    fresh = []
    for f in unmatched:
        fp = fp_of(f)
        if fp is not None and fp_budget[fp] > 0:
            fp_budget[fp] -= 1
            continue
        fresh.append(f)
    return fresh
