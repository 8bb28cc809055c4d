"""Configuration + CLI flags of the port's linear-regression app (counterpart
of a subset of ``twtml_tpu/config.py``).

Defaults come from the port's own ``resources/reference.conf`` and equal the
JAX package's; flag names and short aliases are the JAX package's.
``--backend`` takes ``cuda|cpu`` (default ``cuda``). ``--wire auto``
resolves by the JAX package's rule: ragged for a back-to-back stream
(``--seconds 0``), padded under a wall clock.
"""

from __future__ import annotations

import sys
from importlib import resources as _importlib_resources

BACKENDS = ("cuda", "cpu")
SOURCES = ("replay", "synthetic")
WIRES = ("auto", "ragged", "padded")
MODES = ("auto", "on", "off")
SHED_POLICIES = ("block", "shed-oldest")


def parse_conf_text(text: str) -> dict[str, str]:
    """Parse the HOCON subset of the .conf files (``key="value"`` /
    ``key=value`` lines, ``#``/``//`` comments)."""
    out: dict[str, str] = {}
    for raw in text.splitlines():
        line = raw.strip()
        if not line or line.startswith("#") or line.startswith("//"):
            continue
        if "=" not in line:
            continue
        key, _, value = line.partition("=")
        value = value.strip()
        if len(value) >= 2 and value[0] == '"':
            end = value.find('"', 1)
            value = value[1:end] if end > 0 else value[1:]
        else:
            for marker in ("#", "//"):
                pos = value.find(marker)
                if pos >= 0:
                    value = value[:pos].rstrip()
        out[key.strip()] = value
    return out


def _load_defaults() -> dict[str, str]:
    ref = _importlib_resources.files("twtml_tpu_torch.resources").joinpath(
        "reference.conf"
    )
    return parse_conf_text(ref.read_text())


class ConfArguments:
    """The knobs of the port's linear-regression app; attribute names are
    the flags' camelCase names, as in the JAX package."""

    def __init__(self) -> None:
        conf = _load_defaults()
        self.appName = "twitter-stream-ml"
        self.lightning: str = conf["lightning"]
        self.twtweb: str = conf["twtweb"]
        self.seconds: int = int(conf["seconds"])
        self.stepSize: float = float(conf["stepSize"])
        self.numIterations: int = int(conf["numIterations"])
        self.miniBatchFraction: float = float(conf["miniBatchFraction"])
        self.numRetweetBegin: int = int(conf["numRetweetBegin"])
        self.numRetweetEnd: int = int(conf["numRetweetEnd"])
        self.numTextFeatures: int = int(conf["numTextFeatures"])
        self.backend: str = conf["backend"]
        self.source: str = conf["source"]
        self.replayFile: str = conf["replayFile"]
        self.replaySpeed: float = float(conf["replaySpeed"])
        self.batchBucket: int = int(conf["batchBucket"])
        self.tokenBucket: int = int(conf["tokenBucket"])
        self.l2Reg: float = float(conf["l2Reg"])
        self.convergenceTol: float = float(conf["convergenceTol"])
        self.modelWatch: str = conf["modelWatch"]
        self.wire: str = conf["wire"]
        self.featurizeNative: str = conf["featurizeNative"]
        self.wireAssemble: str = conf["wireAssemble"]
        self.webTimeout: float = float(conf["webTimeout"])
        self.maxQueueRows: int = int(conf["maxQueueRows"])
        self.shedPolicy: str = conf["shedPolicy"]
        self.checkpointDir: str = conf["checkpointDir"]
        self.checkpointEvery: int = int(conf["checkpointEvery"])
        self.journal: str = conf["journal"]
        self.journalMaxMb: int = int(conf["journalMaxMb"])
        self.history: str = conf["history"]
        self.trace: str = conf["trace"]
        self.traceMaxMb: int = int(conf["traceMaxMb"])
        self.blackbox: str = conf["blackbox"]
        self.faultEvery: int = int(conf["faultEvery"])
        self.chaos: str = conf["chaos"]
        self.recycleAfterMb: int = int(conf["recycleAfterMb"])
        self.sentinel: str = conf["sentinel"]
        self.sentinelRollbacks: int = int(conf["sentinelRollbacks"])
        self.sentinelWindow: int = int(conf["sentinelWindow"])
        self.modelWatchWindow: int = int(conf["modelWatchWindow"])
        self.freshness: str = conf["freshness"]
        self.freshnessSloMs: float = float(conf["freshnessSloMs"])

    def setAppName(self, name: str) -> "ConfArguments":
        self.appName = name
        return self

    def usage(self) -> str:
        return f"""Usage: {self.appName} [options]
  -l, --lightning <lightning_url>              Default: {self.lightning}
  -w, --twtweb <twtweb_url>                    Default: {self.twtweb}
  -s, --seconds <integer number>               Micro-batch interval; 0 = back to back (one
                                               --batchBucket of tweets a batch). Default: {self.seconds}
  --source <replay|synthetic>                  Default: {self.source}
  --replayFile <path.jsonl>                    Tweets to replay with --source replay
  --replaySpeed <float>                        0 = as fast as possible, else x realtime
                                               (replay) or tweets/s (synthetic). Default: {self.replaySpeed}
  --backend <cuda|cpu>                         Device of the model. Default: {self.backend}
  --batchBucket <int>                          Pad batches up to this many rows (0 = power-of-two
                                               buckets); back to back, the tweets a batch. Default: {self.batchBucket}
  --tokenBucket <int>                          Pad each tweet's units to this length (0 = auto).
                                               Default: {self.tokenBucket}
  -p, --stepSize <float>                       Default: {self.stepSize}
  -i, --numIterations <int>                    Default: {self.numIterations}
  -b, --miniBatchFraction <float>              Default: {self.miniBatchFraction}
  -f, --numTextFeatures <int>                  Default: {self.numTextFeatures}
  -B, --numRetweetBegin <int>                  Default: {self.numRetweetBegin}
  -E, --numRetweetEnd <int>                    Default: {self.numRetweetEnd}
  --l2Reg <float>                              Default: {self.l2Reg}
  --convergenceTol <float>                     Default: {self.convergenceTol}
  --modelWatch <on|off>                        In-step quality vector. Default: {self.modelWatch}
  --wire <auto|ragged|padded>                  Units wire: ragged ships the rows' units concatenated
                                               with uint16 length deltas in ONE packed buffer (one
                                               H2D copy; the step re-pads on the device), padded
                                               ships a [B, L] buffer and four more arrays. auto =
                                               ragged back to back (--seconds 0), padded under a
                                               wall clock. Default: {self.wire}
  --featurizeNative <auto|on|off>              One-pass native featurize of the ragged wire's arrays
                                               (native/featurize.cpp, built with g++ at first use);
                                               auto/on = whenever it loads, off = numpy. Byte-equal
                                               either way. Default: {self.featurizeNative}
  --wireAssemble <auto|on|off>                 One-pass native pack of the ragged wire
                                               (native/wireassemble.cpp); auto/on = whenever it
                                               loads, off = numpy. Byte-equal either way.
                                               Default: {self.wireAssemble}
  --webTimeout <float seconds>                 Dashboard/Lightning request timeout (per publish).
                                               Default: {self.webTimeout}
  --maxQueueRows <int rows>                    Bound of the source->batcher intake queue: 0 = auto
                                               (8 x --batchBucket when pinned, else unbounded),
                                               -1 = unbounded. Default: {self.maxQueueRows}
  --shedPolicy <block|shed-oldest>             When the intake queue is full: block the source,
                                               or drop the oldest queued rows. Default: {self.shedPolicy}
  --checkpointDir <path>                       Checkpoint/resume: verified .npz archives (CRC, finite
                                               check, quarantine), restored at start, the sentinel's
                                               rollback target; the JAX package's archive format.
  --checkpointEvery <int batches>              Checkpoint cadence (each save drains the fetch
                                               pipeline). Default: {self.checkpointEvery}
  --journal <auto|on|off>                      Durable intake journal: CRC-framed raw rows at the
                                               intake seam, replayed after a rollback or a restart
                                               instead of lost; auto = on iff --checkpointDir.
                                               Default: {self.journal}
  --journalMaxMb <int MB>                      Journal disk ceiling. Default: {self.journalMaxMb}
  --history <auto|on|off>                      Telemetry historian: not ported; auto resolves on
                                               with --checkpointDir and then stops the run, so
                                               pass --history off. Default: {self.history}
  --trace <path.trace>                         Chrome-trace-event pipeline trace (Perfetto).
  --traceMaxMb <int MB>                        Rotate the --trace file at this size; 0 = never.
                                               Default: {self.traceMaxMb}
  --blackbox <on|off>                          Crash flight recorder: a ring of recent events,
                                               dumped as one post-mortem bundle on an abort or
                                               SIGTERM. Default: {self.blackbox}
  --faultEvery <int tweets>                    Inject a source crash every N tweets. Default: {self.faultEvery}
  --chaos <spec>                               Seeded fault injection: TARGET[:ACTION][@TRIGGER]
                                               clauses over fetch|step|web (delay=S, stall=S,
                                               error) and source.nan|source.burst[:rows=N]|
                                               source.garbage; TRIGGER N, pP or fromN; seed=N.
  --recycleAfterMb <int MB>                    Checkpoint and re-exec in place once RSS crosses
                                               this (needs --checkpointDir); 0 = off.
                                               Default: {self.recycleAfterMb}
  --sentinel <on|off>                          Divergence sentinel: a non-finite batch is skipped
                                               and the model rolls back to the last verified
                                               checkpoint (zeros without one). Default: {self.sentinel}
  --sentinelRollbacks <int>                    Abort after this many rollbacks within
                                               --sentinelWindow batches; 0 = never. Default: {self.sentinelRollbacks}
  --sentinelWindow <int batches>               Default: {self.sentinelWindow}
  --modelWatchWindow <int batches>             Force one verified checkpoint after the model watch
                                               holds 'alert' this long. Default: {self.modelWatchWindow}
  --freshness <on|off>                         Event-time lag, watermark and critical edge of every
                                               batch from its lineage. Default: {self.freshness}
  --freshnessSloMs <float ms>                  Warn-only freshness SLO (forces one checkpoint an
                                               episode); 0 = none. Default: {self.freshnessSloMs}
  -h, --help
"""

    def printUsage(self, exit_code: int) -> None:
        print(self.usage(), file=sys.stderr if exit_code else sys.stdout)
        raise SystemExit(exit_code)

    def parse(self, args: list[str]) -> "ConfArguments":
        """Apply ``args`` (flag value pairs); an unknown flag, a missing or
        malformed value prints the usage and exits 1."""
        setters = {
            "--lightning": ("lightning", str),
            "-l": ("lightning", str),
            "--twtweb": ("twtweb", str),
            "-w": ("twtweb", str),
            "--seconds": ("seconds", int),
            "-s": ("seconds", int),
            "--source": ("source", str),
            "--replayFile": ("replayFile", str),
            "--replaySpeed": ("replaySpeed", float),
            "--backend": ("backend", str),
            "--batchBucket": ("batchBucket", int),
            "--tokenBucket": ("tokenBucket", int),
            "--stepSize": ("stepSize", float),
            "-p": ("stepSize", float),
            "--numIterations": ("numIterations", int),
            "-i": ("numIterations", int),
            "--miniBatchFraction": ("miniBatchFraction", float),
            "-b": ("miniBatchFraction", float),
            "--numTextFeatures": ("numTextFeatures", int),
            "-f": ("numTextFeatures", int),
            "--numRetweetBegin": ("numRetweetBegin", int),
            "-B": ("numRetweetBegin", int),
            "--numRetweetEnd": ("numRetweetEnd", int),
            "-E": ("numRetweetEnd", int),
            "--l2Reg": ("l2Reg", float),
            "--convergenceTol": ("convergenceTol", float),
            "--modelWatch": ("modelWatch", str),
            "--wire": ("wire", str),
            "--featurizeNative": ("featurizeNative", str),
            "--wireAssemble": ("wireAssemble", str),
            "--webTimeout": ("webTimeout", float),
            "--maxQueueRows": ("maxQueueRows", int),
            "--shedPolicy": ("shedPolicy", str),
            "--checkpointDir": ("checkpointDir", str),
            "--checkpointEvery": ("checkpointEvery", int),
            "--journal": ("journal", str),
            "--journalMaxMb": ("journalMaxMb", int),
            "--history": ("history", str),
            "--trace": ("trace", str),
            "--traceMaxMb": ("traceMaxMb", int),
            "--blackbox": ("blackbox", str),
            "--faultEvery": ("faultEvery", int),
            "--chaos": ("chaos", str),
            "--recycleAfterMb": ("recycleAfterMb", int),
            "--sentinel": ("sentinel", str),
            "--sentinelRollbacks": ("sentinelRollbacks", int),
            "--sentinelWindow": ("sentinelWindow", int),
            "--modelWatchWindow": ("modelWatchWindow", int),
            "--freshness": ("freshness", str),
            "--freshnessSloMs": ("freshnessSloMs", float),
        }
        i = 0
        while i < len(args):
            flag = args[i]
            if flag in ("-h", "--help"):
                self.printUsage(0)
            if flag not in setters or i + 1 >= len(args):
                self.printUsage(1)
            attr, kind = setters[flag]
            try:
                setattr(self, attr, kind(args[i + 1]))
            except ValueError:
                self.printUsage(1)
            i += 2
        if (
            self.backend not in BACKENDS
            or self.source not in SOURCES
            or self.modelWatch not in ("on", "off")
            or self.seconds < 0
            or self.batchBucket < 0
            or self.tokenBucket < 0
            or self.wire not in WIRES
            or self.featurizeNative not in MODES
            or self.wireAssemble not in MODES
            or self.shedPolicy not in SHED_POLICIES
            or self.journal not in MODES
            or self.journalMaxMb <= 0
            or self.history not in MODES
            or self.blackbox not in ("on", "off")
            or self.sentinel not in ("on", "off")
            or self.freshness not in ("on", "off")
            or self.freshnessSloMs < 0
        ):
            self.printUsage(1)
        return self

    def effective_wire(self) -> str:
        """Resolve ``--wire auto`` by the JAX package's rule
        (``twtml_tpu/config.py`` ``effective_wire``): ragged for a
        back-to-back stream; padded under a wall clock (``--seconds > 0``),
        where intervals are latency-bound and wire bytes do not bind.
        Explicit ``ragged``/``padded`` wins."""
        if self.wire != "auto":
            return self.wire
        return "padded" if self.seconds > 0 else "ragged"

    def effective_journal(self) -> bool:
        """Resolve ``--journal auto`` by the JAX package's rule: on exactly
        when ``--checkpointDir`` is set (the replay cursor lives in verified
        checkpoint meta). Explicit ``on``/``off`` wins; ``on`` without a
        checkpoint directory is refused where the journal is installed."""
        if self.journal != "auto":
            return self.journal == "on"
        return bool(self.checkpointDir)

    def effective_history(self) -> bool:
        """Resolve ``--history auto`` by the same rule. The historian is not
        ported: the app raises when this resolves on."""
        if self.history != "auto":
            return self.history == "on"
        return bool(self.checkpointDir)

    def effective_max_queue_rows(self) -> int:
        """Resolve ``--maxQueueRows``: explicit > 0 wins; 0 sizes the bound
        at 8 pinned row buckets (unbounded without a pinned bucket); -1 is
        explicitly unbounded."""
        if self.maxQueueRows > 0:
            return self.maxQueueRows
        if self.maxQueueRows < 0:
            return 0
        return 8 * self.batchBucket if self.batchBucket > 0 else 0
