"""Publishing: the report after training.

Port of ``veles_tpu/publishing/__init__.py`` (ref: veles/publishing/::
Publisher and its HTML, PDF and Confluence backends [M]).  Gathers the
run's facts (workflow, epochs, metrics, plots) from the host copies the
Decision keeps and renders them through a backend: Markdown,
self-contained HTML, JSON, a Confluence storage-format page (with
``publish_confluence`` to upload it) and a PDF (matplotlib, imported
when it renders).
"""

from __future__ import annotations

import base64
import html
import json
import os
import time


def gather(workflow, launcher=None, plots=()):
    """Collect the report facts from a finished workflow."""
    decision = getattr(workflow, "decision", None)
    facts = {
        "workflow": workflow.name,
        "workflow_class": type(workflow).__name__,
        "generated_at": time.strftime("%Y-%m-%d %H:%M:%S"),
        "run_seconds": getattr(launcher, "run_seconds", None),
        "best_metric": getattr(decision, "best_metric", None),
        "best_epoch": getattr(decision, "best_epoch", None),
        "epochs": [],
        "units": [u.name for u in workflow],
        "plots": list(plots),
    }
    if decision is not None:
        for i, epoch in enumerate(decision.epoch_metrics):
            row = {"epoch": i + 1}
            for set_name, metrics in epoch.items():
                for key, value in metrics.items():
                    if isinstance(value, (int, float)):
                        row["%s_%s" % (set_name, key)] = value
            facts["epochs"].append(row)
    return facts


class MarkdownBackend:
    suffix = ".md"

    def render(self, facts):
        lines = ["# Training report: %s" % facts["workflow"],
                 "",
                 "- class: `%s`" % facts["workflow_class"],
                 "- generated: %s" % facts["generated_at"],
                 "- best metric: **%s** (epoch %s)"
                 % (facts["best_metric"], facts["best_epoch"])]
        if facts["run_seconds"]:
            lines.append("- run time: %.1fs" % facts["run_seconds"])
        if facts["epochs"]:
            keys = sorted({k for row in facts["epochs"] for k in row})
            lines += ["", "| " + " | ".join(keys) + " |",
                      "|" + "---|" * len(keys)]
            for row in facts["epochs"]:
                lines.append("| " + " | ".join(
                    ("%.6g" % row[k]) if isinstance(row.get(k), float)
                    else str(row.get(k, "")) for k in keys) + " |")
        lines += ["", "Units: " + ", ".join(facts["units"])]
        return "\n".join(lines) + "\n"


def _xml_cell(row, key):
    """One escaped table cell: floats formatted, everything else
    html-escaped — an unescaped & or < malforms an HTML report and
    400s a Confluence storage-format POST (shared by both backends)."""
    value = row.get(key)
    if isinstance(value, float):
        return "%.6g" % value
    return html.escape(str(value if value is not None else ""))


class HTMLBackend:
    suffix = ".html"

    def render(self, facts):
        rows = ""
        if facts["epochs"]:
            keys = sorted({k for row in facts["epochs"] for k in row})
            head = "".join("<th>%s</th>" % html.escape(k) for k in keys)
            body = ""
            for row in facts["epochs"]:
                body += "<tr>" + "".join(
                    "<td>%s</td>" % _xml_cell(row, k) for k in keys) + \
                    "</tr>"
            rows = "<table><tr>%s</tr>%s</table>" % (head, body)
        imgs = ""
        for path in facts["plots"]:
            if os.path.exists(path):
                with open(path, "rb") as f:
                    b64 = base64.b64encode(f.read()).decode("ascii")
                imgs += ('<img src="data:image/png;base64,%s" '
                         'style="max-width:45%%; margin:4px"/>' % b64)
        return ("<!doctype html><html><head><meta charset='utf-8'>"
                "<title>%(name)s report</title></head><body>"
                "<h1>Training report: %(name)s</h1>"
                "<p>class <code>%(cls)s</code> — generated %(at)s</p>"
                "<p>best metric <b>%(best)s</b> at epoch %(epoch)s</p>"
                "%(rows)s%(imgs)s</body></html>") % {
            "name": html.escape(str(facts["workflow"])),
            "cls": html.escape(str(facts["workflow_class"])),
            "at": html.escape(str(facts["generated_at"])),
            "best": html.escape(str(facts["best_metric"])),
            "epoch": html.escape(str(facts["best_epoch"])),
            "rows": rows,
            "imgs": imgs,
        }


class JSONBackend:
    suffix = ".json"

    def render(self, facts):
        return json.dumps(facts, indent=2, default=str)


class ConfluenceBackend:
    """Confluence storage-format page body (ref: veles/publishing/
    confluence_backend [M]).  Renders the XHTML-based storage format a
    Confluence ``/rest/api/content`` POST accepts; pair with
    :func:`publish_confluence` to upload."""

    suffix = ".confluence.xml"

    def render(self, facts):
        rows = ""
        if facts["epochs"]:
            keys = sorted({k for row in facts["epochs"] for k in row})
            head = "".join("<th>%s</th>" % html.escape(k) for k in keys)
            body = ""
            for row in facts["epochs"]:
                body += "<tr>" + "".join(
                    "<td>%s</td>" % _xml_cell(row, k)
                    for k in keys) + "</tr>"
            rows = "<table><tbody><tr>%s</tr>%s</tbody></table>" % (
                head, body)
        return ("<h1>Training report: %(name)s</h1>"
                "<p>class <code>%(cls)s</code> — generated %(at)s</p>"
                "<p>best metric <strong>%(best)s</strong> at epoch "
                "%(epoch)s</p>"
                '<ac:structured-macro ac:name="code">'
                "<ac:plain-text-body><![CDATA[units: %(units)s]]>"
                "</ac:plain-text-body></ac:structured-macro>"
                "%(rows)s") % {
            "name": html.escape(str(facts["workflow"])),
            "cls": html.escape(str(facts["workflow_class"])),
            "at": html.escape(str(facts["generated_at"])),
            "best": html.escape(str(facts["best_metric"])),
            "epoch": html.escape(str(facts["best_epoch"])),
            "units": ", ".join(facts["units"]),
            "rows": rows,
        }


def publish_confluence(base_url, space_key, title, facts, auth=None):
    """Create a Confluence page holding the report (the reference's
    confluence upload flow, via the stable REST API instead of its
    XML-RPC).  ``auth`` is a (user, token) pair for basic auth; returns
    the decoded JSON response."""
    import base64 as b64
    import urllib.request
    payload = {
        "type": "page",
        "title": title,
        "space": {"key": space_key},
        "body": {"storage": {
            "value": ConfluenceBackend().render(facts),
            "representation": "storage"}},
    }
    req = urllib.request.Request(
        base_url.rstrip("/") + "/rest/api/content",
        data=json.dumps(payload).encode(),
        headers={"Content-Type": "application/json"})
    if auth is not None:
        req.add_header(
            "Authorization", "Basic " + b64.b64encode(
                ("%s:%s" % auth).encode()).decode("ascii"))
    with urllib.request.urlopen(req, timeout=30) as resp:
        return json.loads(resp.read())


class PDFBackend:
    """Print report via matplotlib PdfPages (ref: veles/publishing/
    pdf_backend [M]): a summary page plus per-metric learning curves.

    Chart choices: change over time → line marks; metrics of different
    scales never share an axis — each
    metric gets its own small-multiple panel (single series, titled, so
    no legend is needed); recessive grid, thin 2px lines."""

    suffix = ".pdf"
    binary = True

    SURFACE = "#fcfcfb"
    INK = "#0b0b0b"
    INK2 = "#52514e"
    SERIES = "#2a78d6"

    def render(self, facts):
        import io
        import matplotlib
        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
        from matplotlib.backends.backend_pdf import PdfPages

        buf = io.BytesIO()
        with PdfPages(buf) as pdf:
            fig = plt.figure(figsize=(8.27, 11.69))   # A4 portrait
            fig.patch.set_facecolor(self.SURFACE)
            lines = [
                ("Training report: %s" % facts["workflow"], 16, self.INK),
                ("", 10, self.INK2),
                ("class %s" % facts["workflow_class"], 10, self.INK2),
                ("generated %s" % facts["generated_at"], 10, self.INK2),
                ("best metric %s (epoch %s)"
                 % (facts["best_metric"], facts["best_epoch"]), 11,
                 self.INK),
            ]
            if facts["run_seconds"]:
                lines.append(("run time %.1f s" % facts["run_seconds"],
                              10, self.INK2))
            lines.append(("units: %s" % ", ".join(facts["units"]), 9,
                          self.INK2))
            y = 0.93
            for text, size, color in lines:
                fig.text(0.08, y, text, fontsize=size, color=color,
                         family="monospace", wrap=True)
                y -= 0.035
            pdf.savefig(fig)
            plt.close(fig)

            rows = facts["epochs"]
            keys = sorted({k for row in rows for k in row
                           if k != "epoch"}) if rows else []
            if keys:
                epochs = [row["epoch"] for row in rows]
                ncols = 2
                nrows = (len(keys) + ncols - 1) // ncols
                fig, axes = plt.subplots(
                    nrows, ncols, figsize=(8.27, 2.6 * nrows),
                    squeeze=False)
                fig.patch.set_facecolor(self.SURFACE)
                for ax in axes.flat[len(keys):]:
                    ax.axis("off")
                for ax, key in zip(axes.flat, keys):
                    ys = [row.get(key) for row in rows]
                    xs = [e for e, v in zip(epochs, ys) if v is not None]
                    ax.plot(xs, [v for v in ys if v is not None],
                            color=self.SERIES, linewidth=2)
                    ax.set_title(key, fontsize=9, color=self.INK,
                                 family="monospace", loc="left")
                    ax.set_xlabel("epoch", fontsize=8, color=self.INK2)
                    from matplotlib.ticker import MaxNLocator
                    ax.xaxis.set_major_locator(
                        MaxNLocator(integer=True))
                    ax.tick_params(labelsize=7, colors=self.INK2)
                    ax.set_facecolor(self.SURFACE)
                    ax.grid(True, color="#e4e3df", linewidth=0.6)
                    for side in ("top", "right"):
                        ax.spines[side].set_visible(False)
                    for side in ("left", "bottom"):
                        ax.spines[side].set_color(self.INK2)
                fig.tight_layout()
                pdf.savefig(fig)
                plt.close(fig)
        return buf.getvalue()


BACKENDS = {"markdown": MarkdownBackend, "html": HTMLBackend,
            "json": JSONBackend, "pdf": PDFBackend,
            "confluence": ConfluenceBackend}


class Publisher:
    """Render a finished workflow's report with the chosen backends."""

    def __init__(self, backends=("markdown", "html")):
        self.backends = [BACKENDS[b]() if isinstance(b, str) else b
                         for b in backends]

    def publish(self, workflow, out_dir, launcher=None, plots=()):
        facts = gather(workflow, launcher, plots)
        os.makedirs(out_dir, exist_ok=True)
        paths = []
        for backend in self.backends:
            path = os.path.join(
                out_dir, "report_%s%s" % (facts["workflow"], backend.suffix))
            if getattr(backend, "binary", False):
                with open(path, "wb") as f:
                    f.write(backend.render(facts))
            else:
                with open(path, "w", encoding="utf-8") as f:
                    f.write(backend.render(facts))
            paths.append(path)
        return paths
