"""Live operator endpoints: ``/metrics`` (OpenMetrics), ``/statusz``,
``/programz``, ``/healthz``, ``/qualityz``: a stdlib ``http.server``
thread over the process's own state (PyTorch port of
``telemetry/exporter.py``, with the same text and the same checker).

Scrape discipline: every endpoint renders **already-collected** state:
``global_metrics().snapshot()`` (counters, gauges, histograms and the live
``fleet/*``, ``elastic/*`` and ``quality/*`` sources), the program
inventory's stored rows (``telemetry/programz.py``) and the watchdog's
current verdict.  A scrape launches no kernel, makes no nvcc build and
captures no CUDA graph, mid-fit and mid-serve alike; sources run outside
the registry lock and take only their owner's locks.  It never
initializes CUDA either: ``/statusz``'s ``backend`` reads ``"cuda"`` only
once the process has brought CUDA up (``torch.cuda.is_initialized()``),
as the JAX package's scrape never imports JAX.

:class:`OperatorPlane` is the one-call bundle (program inventory,
:class:`~spark_ensemble_tpu_torch.telemetry.programz.HbmSampler`, the
port's :class:`~spark_ensemble_tpu_torch.telemetry.watchdog.Watchdog` and
the HTTP server); ``python -m spark_ensemble_tpu_torch.telemetry.exporter
--snapshot DIR`` writes this process's state as files, and ``--validate
FILE`` runs the stdlib OpenMetrics syntax checker on an exposition file.
"""

from __future__ import annotations

import argparse
import json
import os
import re
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any, Dict, List, Optional, Tuple
from urllib.parse import parse_qs, urlparse

__all__ = [
    "render_openmetrics",
    "validate_openmetrics",
    "OperatorServer",
    "OperatorPlane",
    "start_operator_plane",
    "write_snapshot",
]

#: every exported sample lives under this prefix, so one grep isolates
#: the package's metrics in a shared scrape
METRIC_PREFIX = "se_tpu"

_NAME_RE = re.compile(r"[^a-zA-Z0-9_:]")


def _metric_name(name: str) -> str:
    n = _NAME_RE.sub("_", name.strip("/"))
    if n and n[0].isdigit():
        n = "_" + n
    return f"{METRIC_PREFIX}_{n}"


def _escape_label(value: str) -> str:
    return (
        str(value)
        .replace("\\", "\\\\")
        .replace("\"", "\\\"")
        .replace("\n", "\\n")
    )


def _fmt(value: float) -> str:
    f = float(value)
    if f != f:
        return "NaN"
    if f == int(f) and abs(f) < 1e15:
        return str(int(f))
    return repr(f)


def _flatten_numeric(value: Any, path: str = "") -> List[Tuple[str, float]]:
    """Numeric/bool leaves of a source payload as (dotted path, value) —
    strings and nulls drop out (they are /statusz material, not samples)."""
    out: List[Tuple[str, float]] = []
    if isinstance(value, bool):
        out.append((path, 1.0 if value else 0.0))
    elif isinstance(value, (int, float)):
        out.append((path, float(value)))
    elif isinstance(value, dict):
        for k in sorted(value, key=str):
            sub = f"{path}.{k}" if path else str(k)
            out.extend(_flatten_numeric(value[k], sub))
    elif isinstance(value, (list, tuple)):
        out.append((f"{path}.len" if path else "len", float(len(value))))
    return out


def render_openmetrics(
    snapshot: Optional[Dict[str, Dict[str, Any]]] = None,
) -> str:
    """Render a ``MetricsRegistry.snapshot()`` as OpenMetrics 1.0 text.

    Counters become ``counter`` families (``_total`` samples), gauges
    ``gauge``, streaming histograms ``summary`` (p50/p90/p99 quantiles +
    ``_count``/``_sum`` — the registry keeps log2 buckets, not
    Prometheus-native ones, so quantiles are the honest export).  Live
    sources (``fleet/<stream>``, ``elastic/<label>``) flatten their
    numeric leaves into one gauge family per source group with
    ``source`` and ``field`` labels."""
    if snapshot is None:
        from spark_ensemble_tpu_torch.telemetry.events import global_metrics

        snapshot = global_metrics().snapshot()
    plain: List[str] = []
    by_group: Dict[str, List[str]] = {}
    for name in sorted(snapshot):
        snap = snapshot[name]
        kind = snap.get("type")
        if kind == "counter":
            m = _metric_name(name)
            plain.append(f"# TYPE {m} counter")
            plain.append(f"{m}_total {_fmt(snap.get('value') or 0)}")
        elif kind == "gauge":
            value = snap.get("value")
            if value is None:
                continue
            m = _metric_name(name)
            plain.append(f"# TYPE {m} gauge")
            plain.append(f"{m} {_fmt(value)}")
        elif kind == "histogram":
            if not snap.get("count"):
                continue
            m = _metric_name(name)
            plain.append(f"# TYPE {m} summary")
            for q in ("0.5", "0.9", "0.99"):
                qv = snap.get({"0.5": "p50", "0.9": "p90", "0.99": "p99"}[q])
                if qv is not None:
                    plain.append(f'{m}{{quantile="{q}"}} {_fmt(qv)}')
            plain.append(f"{m}_count {_fmt(snap['count'])}")
            plain.append(f"{m}_sum {_fmt(snap.get('sum', 0.0))}")
        elif kind == "source":
            if "value" not in snap:
                continue  # erroring source: reported on /statusz instead
            group = name.split("/", 1)[0] if "/" in name else "source"
            stream = name.split("/", 1)[1] if "/" in name else name
            lines = by_group.setdefault(group, [])
            src = _escape_label(stream)
            for field, value in _flatten_numeric(snap["value"]):
                lines.append(
                    f'{_metric_name(group)}{{source="{src}",'
                    f'field="{_escape_label(field)}"}} {_fmt(value)}'
                )
    out: List[str] = list(plain)
    for group in sorted(by_group):
        out.append(f"# TYPE {_metric_name(group)} gauge")
        out.extend(by_group[group])
    out.append("# EOF")
    return "\n".join(out) + "\n"


# ---------------------------------------------------------------------------
# stdlib OpenMetrics syntax checker (the scrape validator)
# ---------------------------------------------------------------------------

_TYPE_RE = re.compile(
    r"^# TYPE ([a-zA-Z_:][a-zA-Z0-9_:]*) "
    r"(counter|gauge|summary|histogram|info|stateset|unknown)$"
)
_META_RE = re.compile(r"^# (HELP|UNIT) ([a-zA-Z_:][a-zA-Z0-9_:]*) ?(.*)$")
_SAMPLE_RE = re.compile(
    r"^([a-zA-Z_:][a-zA-Z0-9_:]*)"
    r"(?:\{((?:[a-zA-Z_][a-zA-Z0-9_]*=\"(?:[^\"\\]|\\.)*\",?)*)\})?"
    r" (-?(?:[0-9]*\.?[0-9]+(?:[eE][+-]?[0-9]+)?|Inf)|NaN|[+-]Inf)"
    r"(?: -?[0-9]+(?:\.[0-9]+)?)?$"
)

#: sample-name suffixes each family type may emit
_TYPE_SUFFIXES = {
    "counter": ("_total", "_created"),
    "gauge": ("",),
    "summary": ("", "_count", "_sum", "_created"),
    "histogram": ("_bucket", "_count", "_sum", "_created"),
    "info": ("_info",),
    "stateset": ("",),
    "unknown": ("",),
}


def validate_openmetrics(text: str) -> List[str]:
    """Line-level OpenMetrics 1.0 syntax check — pure stdlib, no client
    library.  Returns a list of violations (empty == valid): parseable
    metadata/sample lines only, every sample under a declared family
    with a type-legal suffix, no family re-declaration or interleaving,
    exactly one terminal ``# EOF``."""
    errors: List[str] = []
    lines = text.splitlines()
    if not lines or lines[-1] != "# EOF":
        errors.append("exposition must end with a terminal '# EOF' line")
    types: Dict[str, str] = {}
    closed: set = set()
    current: Optional[str] = None

    def _family_of(sample: str) -> Optional[str]:
        best = None
        for fam, kind in types.items():
            for suffix in _TYPE_SUFFIXES[kind]:
                if sample == fam + suffix and (
                    best is None or len(fam) > len(best)
                ):
                    best = fam
        return best

    for i, line in enumerate(lines, 1):
        if line == "# EOF":
            if i != len(lines):
                errors.append(f"line {i}: content after '# EOF'")
                break
            continue
        if not line or line[0] == "#":
            m = _TYPE_RE.match(line)
            if m:
                fam, kind = m.group(1), m.group(2)
                if fam in types:
                    errors.append(f"line {i}: duplicate TYPE for '{fam}'")
                if current is not None:
                    closed.add(current)
                types[fam] = kind
                current = fam
                continue
            if _META_RE.match(line):
                continue
            errors.append(f"line {i}: unparseable comment/metadata: {line!r}")
            continue
        m = _SAMPLE_RE.match(line)
        if not m:
            errors.append(f"line {i}: unparseable sample line: {line!r}")
            continue
        fam = _family_of(m.group(1))
        if fam is None:
            errors.append(
                f"line {i}: sample '{m.group(1)}' has no declared TYPE "
                "family (or an illegal suffix for its type)"
            )
            continue
        if fam != current:
            if fam in closed:
                errors.append(
                    f"line {i}: family '{fam}' interleaved with other "
                    "families (samples must be contiguous)"
                )
            if current is not None:
                closed.add(current)
            current = fam
    return errors


# ---------------------------------------------------------------------------
# HTTP server
# ---------------------------------------------------------------------------

OPENMETRICS_CONTENT_TYPE = (
    "application/openmetrics-text; version=1.0.0; charset=utf-8"
)


class _Handler(BaseHTTPRequestHandler):
    server_version = "se-tpu-operator"

    def log_message(self, fmt, *args):  # noqa: D102 - silence per-scrape
        pass  # log lines (scrapes are periodic; stderr noise helps nobody)

    def _send(self, code: int, body: bytes, content_type: str) -> None:
        self.send_response(code)
        self.send_header("Content-Type", content_type)
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def _send_json(self, payload: Any, code: int = 200) -> None:
        body = json.dumps(payload, sort_keys=True, default=str).encode()
        self._send(code, body, "application/json; charset=utf-8")

    def do_GET(self):  # noqa: N802 - http.server API
        srv: "OperatorServer" = self.server  # type: ignore[assignment]
        url = urlparse(self.path)
        try:
            if url.path == "/metrics":
                srv.scrapes.inc()
                text = render_openmetrics(srv.registry.snapshot())
                self._send(200, text.encode(), OPENMETRICS_CONTENT_TYPE)
            elif url.path == "/statusz":
                self._send_json(srv.statusz())
            elif url.path == "/programz":
                q = parse_qs(url.query)
                top = None
                if q.get("n"):
                    try:
                        top = int(q["n"][0])
                    except ValueError:
                        top = None
                rows = srv.inventory.rows(top=top)
                self._send_json({
                    "programs": rows,
                    "summary": srv.inventory.summary(),
                })
            elif url.path == "/healthz":
                verdict = srv.health_verdict()
                code = 200 if verdict.get("status") == "ok" else 503
                self._send_json(verdict, code=code)
            elif url.path == "/qualityz":
                self._send_json(srv.qualityz())
            else:
                self._send_json({"error": f"no such endpoint {url.path}",
                                 "endpoints": ["/metrics", "/statusz",
                                               "/programz", "/healthz",
                                               "/qualityz"]},
                                code=404)
        except BrokenPipeError:  # scraper went away mid-reply
            pass


class OperatorServer(ThreadingHTTPServer):
    """The endpoint server: binds, serves on a daemon thread, renders the
    process's registry / inventory / watchdog verdict.  ``port=0`` binds
    an ephemeral port; the bound port is ``self.port``."""

    daemon_threads = True

    def __init__(self, host: str = "127.0.0.1", port: int = 0,
                 registry=None, inventory=None, watchdog=None):
        super().__init__((host, int(port)), _Handler)
        if registry is None:
            from spark_ensemble_tpu_torch.telemetry.events import global_metrics

            registry = global_metrics()
        if inventory is None:
            from spark_ensemble_tpu_torch.telemetry import programz

            inventory = programz.global_inventory()
        self.registry = registry
        self.inventory = inventory
        self.watchdog = watchdog
        self.t0 = time.time()
        self.scrapes = self.registry.counter("operator/scrapes")
        self._thread: Optional[threading.Thread] = None

    @property
    def port(self) -> int:
        return self.server_address[1]

    @property
    def url(self) -> str:
        return f"http://{self.server_address[0]}:{self.port}"

    def start(self) -> "OperatorServer":
        if self._thread is None or not self._thread.is_alive():
            self._thread = threading.Thread(
                target=self.serve_forever, name="se-tpu-operator-http",
                daemon=True,
            )
            self._thread.start()
        return self

    def stop(self) -> None:
        self.shutdown()
        t = self._thread
        if t is not None:
            t.join(timeout=5.0)
            self._thread = None
        self.server_close()

    def statusz(self) -> Dict[str, Any]:
        import torch

        # never initialize CUDA for a scrape: report only the backend the
        # process already brought up
        backend = "cuda" if torch.cuda.is_initialized() else "cpu"
        out: Dict[str, Any] = {
            "pid": os.getpid(),
            "uptime_s": time.time() - self.t0,
            "backend": backend,
            "scrapes": self.scrapes.value,
            "programs": self.inventory.summary(),
            "watchdog": self.health_verdict(),
            "metrics": self.registry.snapshot(),
        }
        return out

    def health_verdict(self) -> Dict[str, Any]:
        if self.watchdog is None:
            return {"status": "ok", "watchdog": "not attached"}
        return self.watchdog.verdict()

    def qualityz(self) -> Dict[str, Any]:
        """The model-quality page (docs/quality.md): every live
        ``quality/*`` source (drift monitors, shadow scorers) plus the
        plane's gauges/counters/histograms, and the watchdog's two
        quality rules when one is attached."""
        snapshot = self.registry.snapshot()
        sources: Dict[str, Any] = {}
        series: Dict[str, Any] = {}
        for name, snap in sorted(snapshot.items()):
            if not name.startswith("quality/"):
                continue
            if snap.get("type") == "source":
                sources[name[len("quality/"):]] = snap.get("value")
            else:
                series[name] = snap.get(
                    "value", snap.get("stats", snap)
                )
        rules = {}
        if self.watchdog is not None:
            rules = {
                name: r
                for name, r in self.watchdog.verdict()["rules"].items()
                if name in ("quality_psi_max", "shadow_divergence")
            }
        return {
            "streams": sources,
            "series": series,
            "watchdog": rules,
        }


class OperatorPlane:
    """The whole live operator plane in one handle: program inventory
    enabled, HBM sampler running, watchdog evaluating, endpoints served.
    ``stop()`` tears everything down (inventory capture included) and
    raises if the sampler or the watchdog hit an error while it ran: a
    plane that failed quietly must not pass for a healthy one."""

    def __init__(self, host: str = "127.0.0.1", port: int = 0,
                 watchdog=None, with_watchdog: bool = True,
                 sampler_interval_s: float = 1.0,
                 watchdog_interval_s: float = 2.0,
                 telemetry_path: Optional[str] = None):
        from spark_ensemble_tpu_torch.telemetry import programz

        self.inventory = programz.enable()
        self.sampler = programz.HbmSampler(interval_s=sampler_interval_s)
        if watchdog is None and with_watchdog:
            from spark_ensemble_tpu_torch.telemetry.watchdog import Watchdog

            watchdog = Watchdog(interval_s=watchdog_interval_s,
                                telemetry_path=telemetry_path)
        self.watchdog = watchdog
        self.server = OperatorServer(
            host=host, port=port, inventory=self.inventory,
            watchdog=watchdog,
        )

    @property
    def url(self) -> str:
        return self.server.url

    def start(self) -> "OperatorPlane":
        self.sampler.start()
        if self.watchdog is not None:
            self.watchdog.start()
        self.server.start()
        return self

    def stop(self) -> None:
        from spark_ensemble_tpu_torch.telemetry import programz

        self.server.stop()
        if self.watchdog is not None:
            self.watchdog.stop()
        self.sampler.stop()
        programz.disable()
        for name, part in (("HBM sampler", self.sampler),
                           ("watchdog", self.watchdog)):
            if part is not None and getattr(part, "errors", 0):
                raise RuntimeError(
                    f"operator plane: the {name} failed {part.errors} "
                    f"time(s); last: {part.last_error}"
                )


def start_operator_plane(port: int = 0, **kwargs) -> OperatorPlane:
    """Build and start an :class:`OperatorPlane`."""
    return OperatorPlane(port=port, **kwargs).start()


# ---------------------------------------------------------------------------
# one-shot snapshot mode (files) + CLI
# ---------------------------------------------------------------------------


def write_snapshot(out_dir: str, registry=None, inventory=None,
                   watchdog=None) -> Dict[str, str]:
    """Write ``metrics.txt``, ``statusz.json``, ``programz.json`` and
    ``qualityz.json`` into ``out_dir`` from the current process state;
    returns the paths.  The metrics exposition is validated before it is
    written: an exposition that fails the stdlib checker raises."""
    os.makedirs(out_dir, exist_ok=True)
    srv = OperatorServer.__new__(OperatorServer)  # render without binding
    if registry is None:
        from spark_ensemble_tpu_torch.telemetry.events import global_metrics

        registry = global_metrics()
    if inventory is None:
        from spark_ensemble_tpu_torch.telemetry import programz

        inventory = programz.global_inventory()
    srv.registry = registry
    srv.inventory = inventory
    srv.watchdog = watchdog
    srv.t0 = time.time()
    srv.scrapes = registry.counter("operator/scrapes")
    text = render_openmetrics(registry.snapshot())
    problems = validate_openmetrics(text)
    if problems:
        raise ValueError(
            "generated exposition fails the OpenMetrics checker: "
            + "; ".join(problems[:5])
        )
    paths = {
        "metrics": os.path.join(out_dir, "metrics.txt"),
        "statusz": os.path.join(out_dir, "statusz.json"),
        "programz": os.path.join(out_dir, "programz.json"),
        "qualityz": os.path.join(out_dir, "qualityz.json"),
    }
    with open(paths["metrics"], "w") as f:
        f.write(text)
    with open(paths["statusz"], "w") as f:
        json.dump(srv.statusz(), f, indent=2, sort_keys=True, default=str)
        f.write("\n")
    with open(paths["programz"], "w") as f:
        json.dump({"programs": inventory.rows(),
                   "summary": inventory.summary()},
                  f, indent=2, sort_keys=True, default=str)
        f.write("\n")
    with open(paths["qualityz"], "w") as f:
        json.dump(srv.qualityz(), f, indent=2, sort_keys=True, default=str)
        f.write("\n")
    return paths


def main(argv: Optional[List[str]] = None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument(
        "--snapshot", metavar="DIR", default=None,
        help="write metrics.txt/statusz.json/programz.json/qualityz.json "
        "for this process's current state and exit",
    )
    parser.add_argument(
        "--validate", metavar="FILE", default=None,
        help="run the stdlib OpenMetrics syntax checker on an exposition "
        "file; non-zero exit on violations",
    )
    args = parser.parse_args(argv)
    if args.validate:
        with open(args.validate) as f:
            problems = validate_openmetrics(f.read())
        for p in problems:
            print(p)
        print(json.dumps({"file": args.validate, "ok": not problems,
                          "violations": len(problems)}))
        return 1 if problems else 0
    if args.snapshot:
        paths = write_snapshot(args.snapshot)
        print(json.dumps({"snapshot": paths}))
        return 0
    parser.error("one of --snapshot / --validate is required")
    return 2


if __name__ == "__main__":
    raise SystemExit(main())
