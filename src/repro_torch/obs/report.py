"""Ops report: one self-contained HTML/text artifact per serving run.

A copy of ``repro.obs.report`` (stdlib only); the HTML and
text it renders are the reference's, byte for byte.

Takes the run's windowed time-series (``obs/timeseries.py``), the SLO
monitor's alert log (``obs/slo.py``), and a per-replica summary, and
renders them into a single file with zero external assets — inline CSS
and inline-SVG sparklines, so the artifact opens from a CI tarball or an
email attachment with no server and no CDN.

Layout: a header (run metadata + headline numbers), an alert table
(kind, time, value vs threshold, detail), one sparkline card per series
(grouped by metric name; per-replica label sets overlay as separate
polylines), and a per-replica table (tokens decoded/lost/replayed, pages
shipped, migrations).

``validate_report`` is the CI check (obs-smoke renders a real run's
report and validates it): structural markers + one ``<svg`` per series
group + an entry per alert — template drift fails in CI, not when an
operator opens a blank page mid-incident.

CLI::

    python -m repro_torch.obs.report series.jsonl --alerts alerts.json \
        --out report.html [--text]
"""
from __future__ import annotations

import html as _html
import json
from typing import Any, Dict, Iterable, List, Optional, Sequence

from repro_torch.obs.timeseries import TimeSeries, load_series_jsonl

REPORT_MARKER = "<!-- repro-ops-report v1 -->"

_CSS = """
body { font: 13px/1.45 -apple-system, 'Segoe UI', sans-serif;
       margin: 2em auto; max-width: 64em; color: #1a1a2e; }
h1 { font-size: 1.4em; } h2 { font-size: 1.1em; margin-top: 1.6em; }
table { border-collapse: collapse; margin: .6em 0; }
th, td { border: 1px solid #d0d0e0; padding: .25em .6em; text-align: right; }
th { background: #f0f0f8; } td.l, th.l { text-align: left; }
.cards { display: flex; flex-wrap: wrap; gap: .8em; }
.card { border: 1px solid #d0d0e0; border-radius: 6px; padding: .5em .8em; }
.card .k { color: #667; font-size: .85em; }
.alert { color: #a8323e; font-weight: 600; }
.ok { color: #2e7d46; font-weight: 600; }
svg { display: block; } .legend { color: #667; font-size: .8em; }
"""

_SPARK_W, _SPARK_H = 220, 44
_PALETTE = ("#3b5bdb", "#e8590c", "#2b8a3e", "#9c36b5", "#e03131",
            "#0b7285", "#f08c00", "#5f3dc4")


def _esc(s: Any) -> str:
    return _html.escape(str(s))


def _polyline(ts: TimeSeries, t0: float, t1: float,
              v0: float, v1: float, color: str) -> str:
    """One series as an SVG polyline normalized into the shared card
    viewport (shared axes per group, so overlaid replicas compare)."""
    span_t = (t1 - t0) or 1.0
    span_v = (v1 - v0) or 1.0
    pts = " ".join(
        f"{(t - t0) / span_t * _SPARK_W:.1f},"
        f"{_SPARK_H - (v - v0) / span_v * (_SPARK_H - 4) - 2:.1f}"
        for t, v in zip(ts.times, ts.values))
    return (f'<polyline fill="none" stroke="{color}" stroke-width="1.3" '
            f'points="{pts}"/>')


def _series_card(name: str, group: Sequence[TimeSeries]) -> str:
    """One card: every label-set of ``name`` overlaid on shared axes."""
    all_t = [t for ts in group for t in ts.times]
    all_v = [v for ts in group for v in ts.values]
    if not all_t:
        return (f'<div class="card"><div class="k">{_esc(name)}</div>'
                f'(no samples)</div>')
    t0, t1 = min(all_t), max(all_t)
    v0, v1 = min(all_v), max(all_v)
    lines, legend = [], []
    for i, ts in enumerate(group):
        color = _PALETTE[i % len(_PALETTE)]
        lines.append(_polyline(ts, t0, t1, v0, v1, color))
        lab = ",".join(f"{k}={v}" for k, v in sorted(ts.labels.items()))
        last = ts.last()
        legend.append(f'<span style="color:{color}">■</span> '
                      f'{_esc(lab) or "·"} = {last[1]:.4g}')
    return (f'<div class="card"><div class="k">{_esc(name)} '
            f'[{v0:.4g} … {v1:.4g}]</div>'
            f'<svg width="{_SPARK_W}" height="{_SPARK_H}" '
            f'viewBox="0 0 {_SPARK_W} {_SPARK_H}">{"".join(lines)}</svg>'
            f'<div class="legend">{" &nbsp; ".join(legend)}</div></div>')


def _group_series(series: Dict[str, TimeSeries]
                  ) -> Dict[str, List[TimeSeries]]:
    groups: Dict[str, List[TimeSeries]] = {}
    for ts in series.values():
        groups.setdefault(ts.name, []).append(ts)
    return groups


def _alert_dicts(alerts: Iterable[Any]) -> List[Dict[str, Any]]:
    out = []
    for a in alerts:
        out.append(a if isinstance(a, dict) else a.to_json())
    return out


def render_report(*, series: Dict[str, TimeSeries],
                  alerts: Iterable[Any] = (),
                  replicas: Sequence[Dict[str, Any]] = (),
                  summary: Optional[Dict[str, Any]] = None,
                  title: str = "Serving ops report") -> str:
    """Render the self-contained HTML artifact. ``alerts`` accepts
    ``slo.Alert`` objects or their ``to_json`` dicts; ``replicas`` is a
    list of per-replica stat dicts (keys become columns); ``summary`` is
    the headline key/value block."""
    al = _alert_dicts(alerts)
    parts = ["<!DOCTYPE html>", REPORT_MARKER,
             f"<html><head><meta charset='utf-8'><title>{_esc(title)}"
             f"</title><style>{_CSS}</style></head><body>",
             f"<h1>{_esc(title)}</h1>"]

    if summary:
        cells = "".join(
            f'<div class="card"><div class="k">{_esc(k)}</div>'
            f'{v:.4g}</div>' if isinstance(v, float) else
            f'<div class="card"><div class="k">{_esc(k)}</div>'
            f'{_esc(v)}</div>' for k, v in summary.items())
        parts.append(f'<div class="cards">{cells}</div>')

    n = len(al)
    parts.append(f"<h2>Alerts <span class=\"{'alert' if n else 'ok'}\">"
                 f"({n})</span></h2>")
    if al:
        rows = "".join(
            f'<tr><td class="l alert">{_esc(a["kind"])}</td>'
            f'<td>{a["t_s"]:.2f}</td><td>{a["value"]:.4g}</td>'
            f'<td>{a["threshold"]:.4g}</td>'
            f'<td class="l">{_esc(json.dumps(a.get("detail", {})))}</td></tr>'
            for a in al)
        parts.append('<table><tr><th class="l">kind</th><th>t (s)</th>'
                     '<th>value</th><th>threshold</th>'
                     f'<th class="l">detail</th></tr>{rows}</table>')
    else:
        parts.append('<p class="ok">no alerts fired</p>')

    groups = _group_series(series)
    parts.append(f"<h2>Time-series ({len(groups)} metrics, "
                 f"{len(series)} series)</h2>")
    parts.append('<div class="cards">' + "".join(
        _series_card(name, group)
        for name, group in sorted(groups.items())) + "</div>")

    if replicas:
        cols = sorted({k for r in replicas for k in r},
                      key=lambda k: (k != "replica", k))
        head = "".join(f'<th class="l">{_esc(c)}</th>' if c == "replica"
                       else f"<th>{_esc(c)}</th>" for c in cols)
        rows = "".join(
            "<tr>" + "".join(
                f'<td class="l">{_esc(r.get(c, ""))}</td>' if c == "replica"
                else f'<td>{_esc(r.get(c, ""))}</td>' for c in cols)
            + "</tr>" for r in replicas)
        parts.append(f"<h2>Replicas ({len(replicas)})</h2>"
                     f"<table><tr>{head}</tr>{rows}</table>")

    parts.append("</body></html>")
    return "\n".join(parts)


def render_text(*, series: Dict[str, TimeSeries],
                alerts: Iterable[Any] = (),
                replicas: Sequence[Dict[str, Any]] = (),
                summary: Optional[Dict[str, Any]] = None,
                title: str = "Serving ops report", width: int = 32) -> str:
    """Terminal rendering of the same data (block-char sparklines)."""
    blocks = " ▁▂▃▄▅▆▇█"
    lines = [title, "=" * len(title), ""]
    if summary:
        for k, v in summary.items():
            lines.append(f"  {k:<24} "
                         f"{v:.4g}" if isinstance(v, float) else
                         f"  {k:<24} {v}")
        lines.append("")
    al = _alert_dicts(alerts)
    lines.append(f"alerts ({len(al)}):")
    for a in al:
        lines.append(f"  [{a['t_s']:8.2f}s] {a['kind']:<18} "
                     f"{a['value']:.4g} vs {a['threshold']:.4g}")
    if not al:
        lines.append("  (none)")
    lines.append("")
    for key in sorted(series):
        ts = series[key]
        vs = ts.values
        if not vs:
            continue
        lo, hi = min(vs), max(vs)
        span = (hi - lo) or 1.0
        # resample to `width` columns, last value per column
        cols = [""] * min(width, len(vs))
        per = len(vs) / len(cols)
        spark = "".join(
            blocks[1 + int((vs[min(int(i * per), len(vs) - 1)] - lo)
                           / span * (len(blocks) - 2))]
            for i in range(len(cols)))
        lines.append(f"  {key:<40} {spark}  [{lo:.4g} … {hi:.4g}] "
                     f"last={vs[-1]:.4g}")
    if replicas:
        lines.append("")
        lines.append(f"replicas ({len(replicas)}):")
        for r in replicas:
            kv = " ".join(f"{k}={v}" for k, v in r.items())
            lines.append(f"  {kv}")
    return "\n".join(lines) + "\n"


def validate_report(html: str, *, min_series: int = 0,
                    min_alerts: int = 0) -> Dict[str, int]:
    """Structural check for CI: marker + document shell present, one
    ``<svg`` per rendered series group, an alert row per alert. Returns
    the counts so callers can assert against the run that produced it."""
    if REPORT_MARKER not in html:
        raise ValueError("not an ops report: missing marker comment")
    for tag in ("<html", "</html>", "<body", "</body>", "<style>"):
        if tag not in html:
            raise ValueError(f"ops report missing {tag!r}")
    n_svg = html.count("<svg")
    n_alert_rows = html.count('<td class="l alert">')
    if n_svg < min_series:
        raise ValueError(f"ops report has {n_svg} series cards, "
                         f"expected >= {min_series}")
    if n_alert_rows < min_alerts:
        raise ValueError(f"ops report has {n_alert_rows} alert rows, "
                         f"expected >= {min_alerts}")
    return {"svg": n_svg, "alerts": n_alert_rows}


def main(argv: Optional[List[str]] = None) -> None:
    import argparse
    ap = argparse.ArgumentParser(
        description="Render a serving ops report from exported artifacts")
    ap.add_argument("series_jsonl", help="TimeSeriesSampler.write_jsonl output")
    ap.add_argument("--alerts", default=None,
                    help="JSON file: list of Alert.to_json dicts")
    ap.add_argument("--replicas", default=None,
                    help="JSON file: list of per-replica stat dicts")
    ap.add_argument("--out", default="report.html")
    ap.add_argument("--text", action="store_true",
                    help="also print the terminal rendering")
    ap.add_argument("--title", default="Serving ops report")
    args = ap.parse_args(argv)
    series = load_series_jsonl(args.series_jsonl)
    alerts = json.load(open(args.alerts)) if args.alerts else []
    replicas = json.load(open(args.replicas)) if args.replicas else []
    doc = render_report(series=series, alerts=alerts, replicas=replicas,
                        title=args.title)
    counts = validate_report(doc, min_alerts=len(alerts))
    with open(args.out, "w") as f:
        f.write(doc)
    if args.text:
        print(render_text(series=series, alerts=alerts, replicas=replicas,
                          title=args.title))
    print(json.dumps({"out": args.out, "series": len(series),
                      **counts}))


if __name__ == "__main__":
    main()
