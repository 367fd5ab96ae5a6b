"""Self-contained live training dashboard (the ``--visdom`` realization).

The reference renders live loss/WER/CER curves to a visdom *server*
(reference train.py:155-314). A training host need not run one; this
module renders the same three live streams to a single self-refreshing
HTML file — open ``<log-dir>/<run-id>.html`` in any browser, no server,
no dependencies — regenerated by MetricsLogger as events arrive.

Charts (one y-axis each; line = change-over-time):
* training loss vs iteration (batch loss + running average);
* per-epoch loss (train average + validation);
* validation quality in % (WER + CER).

Design follows the in-house data-viz method: series colors are slots 1-2
of its validated reference palette (light #2a78d6/#eb6834, dark
#3987e5/#d95926 — pre-validated for CVD separation and contrast on both
surfaces), 2px line marks, recessive grid, legend + direct end-labels,
text in ink tokens (never series color), dark mode selected via both the
OS preference and a ``data-theme`` override, crosshair+tooltip hover, and
a table view fallback.
"""

from __future__ import annotations

import html
import json
import math

_SERIES_LIGHT = ("#2a78d6", "#eb6834")
_SERIES_DARK = ("#3987e5", "#d95926")

_CSS = """
.viz-root { color-scheme: light;
  --surface-1:#fcfcfb; --surface-2:#f1f0ec;
  --text-primary:#0b0b0b; --text-secondary:#52514e; --text-muted:#8a897f;
  --grid:#e4e2dc; --series-1:%(l1)s; --series-2:%(l2)s;
  background:var(--surface-1); color:var(--text-primary);
  font:14px/1.45 system-ui,sans-serif; margin:0; padding:24px; }
@media (prefers-color-scheme: dark) {
  :root:where(:not([data-theme="light"])) .viz-root { color-scheme: dark;
    --surface-1:#1a1a19; --surface-2:#252523;
    --text-primary:#ffffff; --text-secondary:#c3c2b7; --text-muted:#8a897f;
    --grid:#33332f; --series-1:%(d1)s; --series-2:%(d2)s; } }
:root[data-theme="dark"] .viz-root { color-scheme: dark;
  --surface-1:#1a1a19; --surface-2:#252523;
  --text-primary:#ffffff; --text-secondary:#c3c2b7; --text-muted:#8a897f;
  --grid:#33332f; --series-1:%(d1)s; --series-2:%(d2)s; }
.viz-root h1 { font-size:18px; margin:0 0 2px; }
.viz-root .sub { color:var(--text-secondary); margin:0 0 20px; }
.fig { margin:0 0 28px; max-width:760px; }
.fig h2 { font-size:14px; margin:0 0 2px; font-weight:600; }
.fig .legend { color:var(--text-secondary); font-size:12px;
  margin:0 0 6px; display:flex; gap:16px; }
.legend .chip { display:inline-block; width:10px; height:10px;
  border-radius:3px; margin-right:5px; vertical-align:-1px; }
.fig svg { display:block; background:var(--surface-1); }
.fig .axis text { fill:var(--text-muted); font-size:11px; }
.fig .grid line { stroke:var(--grid); stroke-width:1; }
.fig .s1 { stroke:var(--series-1); } .fig .s2 { stroke:var(--series-2); }
.fig .endlab { font-size:11px; fill:var(--text-secondary); }
.tip { position:fixed; pointer-events:none; background:var(--surface-2);
  color:var(--text-primary); border:1px solid var(--grid); border-radius:6px;
  padding:6px 9px; font-size:12px; display:none; z-index:9; }
.tip .row { display:flex; gap:6px; align-items:center; }
.xline { stroke:var(--text-muted); stroke-width:1; stroke-dasharray:3 3;
  display:none; }
details { max-width:760px; margin:0 0 28px; }
details table { border-collapse:collapse; font-size:12px; }
details td, details th { border:1px solid var(--grid); padding:3px 8px;
  text-align:right; }
"""

_JS = """
const tip = document.getElementById('tip');
document.querySelectorAll('.fig[data-pts]').forEach(fig => {
  const pts = JSON.parse(fig.dataset.pts);   // {x:[], series:{name:[..]}}
  const svg = fig.querySelector('svg');
  const xline = fig.querySelector('.xline');
  const geo = JSON.parse(fig.dataset.geo);   // {x0,x1,w,padl,padr}
  svg.addEventListener('mousemove', ev => {
    if (!pts.x.length) return;
    const r = svg.getBoundingClientRect();
    const px = (ev.clientX - r.left) / r.width * geo.w;
    const fx = (px - geo.padl) / (geo.w - geo.padl - geo.padr);
    let best = 0, bd = 1e30;
    pts.x.forEach((x, i) => {
      const d = Math.abs((x - geo.x0) / Math.max(geo.x1 - geo.x0, 1e-9) - fx);
      if (d < bd) { bd = d; best = i; }
    });
    const sx = geo.padl + (pts.x[best] - geo.x0)
      / Math.max(geo.x1 - geo.x0, 1e-9) * (geo.w - geo.padl - geo.padr);
    xline.setAttribute('x1', sx); xline.setAttribute('x2', sx);
    xline.style.display = 'block';
    let rows = `<div class="row"><b>${fig.dataset.xlabel} ${pts.x[best]}</b></div>`;
    Object.entries(pts.series).forEach(([name, ys], si) => {
      const v = ys[best];
      if (v == null) return;
      rows += `<div class="row"><span class="chip" style="background:var(--series-${si + 1})"></span>${name}: ${Number(v).toPrecision(5)}</div>`;
    });
    tip.innerHTML = rows;
    tip.style.display = 'block';
    tip.style.left = (ev.clientX + 14) + 'px';
    tip.style.top = (ev.clientY + 10) + 'px';
  });
  svg.addEventListener('mouseleave', () => {
    tip.style.display = 'none'; xline.style.display = 'none';
  });
});
// Auto-refresh: always re-arm, skip only the reload while the tab is
// hidden (a single timeout that checks visibility once would never fire
// again after one background tick), and catch up immediately on return.
function armRefresh() {
  setTimeout(() => {
    if (document.hidden) armRefresh(); else location.reload();
  }, 5000);
}
document.addEventListener('visibilitychange', () => {
  if (!document.hidden) location.reload();
});
armRefresh();
"""


def _ticks(lo: float, hi: float, n: int = 4):
    if hi <= lo:
        hi = lo + 1.0
    span = hi - lo
    import math
    step = 10 ** math.floor(math.log10(span / n))
    for mult in (1, 2, 2.5, 5, 10):
        if span / (step * mult) <= n:
            step *= mult
            break
    t0 = math.ceil(lo / step) * step
    out = []
    t = t0
    while t <= hi + 1e-9 * span:
        out.append(round(t, 10))
        t += step
    return out


def _fig(title: str, xlabel: str, xs, series: dict, unit: str = "") -> str:
    """One line figure: xs (list), series {name: list (None = gap)}."""
    w, h, padl, padr, padt, padb = 760, 220, 52, 70, 10, 26
    # Non-finite values (a NaN'd val loss, an inf batch loss before the
    # guard kicks in) become gaps: json.dumps would otherwise emit bare
    # NaN/Infinity tokens — invalid JSON that kills the hover/refresh
    # script's JSON.parse — and min/max below would poison the y scale.
    series = {k: [v if v is not None and math.isfinite(v) else None
                  for v in vs]
              for k, vs in series.items()}
    ys_all = [v for vs in series.values() for v in vs if v is not None]
    if not xs or not ys_all:
        return ""
    x0, x1 = min(xs), max(xs)
    ylo, yhi = min(ys_all), max(ys_all)
    if yhi == ylo:
        yhi = ylo + 1.0
    pad_y = (yhi - ylo) * 0.08
    ylo = min(ylo, 0.0) if ylo >= 0 and ylo < (yhi - ylo) * 0.5 else ylo - pad_y
    yhi += pad_y

    def sx(x):
        return padl + (x - x0) / max(x1 - x0, 1e-9) * (w - padl - padr)

    def sy(y):
        return padt + (yhi - y) / (yhi - ylo) * (h - padt - padb)

    grid, axis = [], []
    for t in _ticks(ylo, yhi):
        if t < ylo or t > yhi:
            continue
        grid.append(f'<line x1="{padl}" y1="{sy(t):.1f}" x2="{w - padr}" '
                    f'y2="{sy(t):.1f}"/>')
        axis.append(f'<text x="{padl - 6}" y="{sy(t) + 4:.1f}" '
                    f'text-anchor="end">{t:g}</text>')
    for t in _ticks(x0, x1, 6):
        if t < x0 or t > x1:
            continue
        axis.append(f'<text x="{sx(t):.1f}" y="{h - 8}" '
                    f'text-anchor="middle">{t:g}</text>')

    paths, endlabs, legend = [], [], []
    for si, (name, vs) in enumerate(series.items()):
        pts = [(sx(x), sy(v)) for x, v in zip(xs, vs) if v is not None]
        if not pts:
            continue
        if len(pts) == 1:
            paths.append(f'<circle class="s{si + 1}" cx="{pts[0][0]:.1f}" '
                         f'cy="{pts[0][1]:.1f}" r="3" '
                         f'fill="var(--series-{si + 1})"/>')
        else:
            d = "M" + " L".join(f"{x:.1f} {y:.1f}" for x, y in pts)
            paths.append(f'<path class="s{si + 1}" d="{d}" fill="none" '
                         'stroke-width="2" stroke-linejoin="round"/>')
        ex, ey = pts[-1]
        endlabs.append(f'<text class="endlab" x="{ex + 6:.1f}" '
                       f'y="{ey + 4:.1f}">{html.escape(name)}</text>')
        legend.append(f'<span><span class="chip" '
                      f'style="background:var(--series-{si + 1})"></span>'
                      f'{html.escape(name)}{unit}</span>')

    data = {"x": list(xs), "series": {k: list(v) for k, v in series.items()}}
    geo = {"x0": x0, "x1": x1, "w": w, "padl": padl, "padr": padr}
    return f"""<div class="fig" data-pts='{json.dumps(data)}'
     data-geo='{json.dumps(geo)}' data-xlabel="{html.escape(xlabel)}">
  <h2>{html.escape(title)}</h2>
  <div class="legend">{''.join(legend)}</div>
  <svg viewBox="0 0 {w} {h}" width="{w}" height="{h}"
       role="img" aria-label="{html.escape(title)}">
    <g class="grid">{''.join(grid)}</g>
    <g class="axis">{''.join(axis)}</g>
    {''.join(paths)}{''.join(endlabs)}
    <line class="xline" y1="{padt}" y2="{h - padb}"/>
  </svg>
</div>"""


def _table(xs, series: dict, xlabel: str) -> str:
    head = f"<tr><th>{html.escape(xlabel)}</th>" + "".join(
        f"<th>{html.escape(k)}</th>" for k in series) + "</tr>"
    rows = []
    for i, x in enumerate(xs):
        cells = "".join(
            f"<td>{'' if vs[i] is None else f'{vs[i]:.4g}'}</td>"
            for vs in series.values())
        rows.append(f"<tr><td>{x}</td>{cells}</tr>")
    return head + "".join(rows)


def render_dashboard(path: str, run_id: str, state: dict) -> None:
    """Write the dashboard HTML. ``state`` carries the accumulated series:
    train_steps/train_loss/train_avg, epochs/epoch_loss/val_loss,
    val_epochs/val_wer/val_cer."""
    css = _CSS % {"l1": _SERIES_LIGHT[0], "l2": _SERIES_LIGHT[1],
                  "d1": _SERIES_DARK[0], "d2": _SERIES_DARK[1]}
    figs = [
        _fig("Training loss", "iter", state.get("train_steps", []),
             {"batch loss": state.get("train_loss", []),
              "running avg": state.get("train_avg", [])}),
        _fig("Per-epoch loss", "epoch", state.get("epochs", []),
             {"train avg": state.get("epoch_loss", []),
              "validation": state.get("val_loss", [])}),
        _fig("Validation quality", "epoch", state.get("val_epochs", []),
             {"WER": state.get("val_wer", []),
              "CER": state.get("val_cer", [])}, unit=" %"),
    ]
    tables = ""
    if state.get("val_epochs"):
        tables = ("<details><summary>Data table (per-epoch)</summary>"
                  "<table>" + _table(
                      state["val_epochs"],
                      {"val loss": state.get("val_loss", []),
                       "WER %": state.get("val_wer", []),
                       "CER %": state.get("val_cer", [])},
                      "epoch") + "</table></details>")
    doc = f"""<!doctype html><html><head><meta charset="utf-8">
<title>{html.escape(run_id)} — live training</title>
<style>{css}</style></head>
<body class="viz-root">
<h1>{html.escape(run_id)}</h1>
<p class="sub">live training dashboard — refreshes every 5 s
(close the tab to stop; data persists in the JSONL event log)</p>
{''.join(f for f in figs if f)}
{tables}
<div class="tip" id="tip"></div>
<script>{_JS}</script>
</body></html>"""
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        f.write(doc)
    import os
    os.replace(tmp, path)
