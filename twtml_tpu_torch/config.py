"""Configuration + CLI flags of the port's linear-regression app (counterpart
of ``twtml_tpu/config.py``).

Defaults come from the port's own ``resources/reference.conf`` and equal the
JAX package's. An ``application.conf`` overrides them as in the JAX package:
the file ``$TWTML_CONFIG`` names, else ``./application.conf`` (the first that
exists; its ``consumerKey``/``consumerSecret``/``accessToken``/
``accessTokenSecret`` land in the ``twitter4j.oauth.*`` property table). The
parser takes every flag and short alias of the JAX package's parser;
``--backend`` is the one deliberate difference (``cuda|cpu``, default
``cuda``). ``--coordinator``/``--numProcesses``/``--processId`` (or a
``twtml://`` master) form a lockstep multi-host group (``multihost``), an
elastic one under ``--elastic on``; the layouts over a model axis, which
the port has not ported, raise ``NotImplementedError`` naming ROADMAP A10c
where they are built. ``--wire auto`` resolves by the JAX package's rule: ragged for
a back-to-back stream (``--seconds 0`` or below) that hashes on the device,
padded under a wall clock or with ``--hashOn host``.
"""

from __future__ import annotations

import os
import sys
from importlib import resources as _importlib_resources

BACKENDS = ("cuda", "cpu")
SOURCES = ("replay", "synthetic", "twitter")
MODES = ("auto", "on", "off")
ON_OFF = ("on", "off")
SHED_POLICIES = ("block", "shed-oldest")

# process-wide property table: the OAuth keys land here under
# ``twitter4j.oauth.*``, as in the JAX package (the reference's JVM
# system properties)
_SYSTEM_PROPERTIES: dict[str, str] = {}
_OAUTH_KEYS = ("consumerKey", "consumerSecret", "accessToken", "accessTokenSecret")


def set_property(key: str, value: str) -> None:
    _SYSTEM_PROPERTIES[key] = value


def get_property(key: str, default: str | None = None) -> str | None:
    return _SYSTEM_PROPERTIES.get(key, default)


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


def _load_application_conf() -> dict[str, str]:
    """The optional override file, as the JAX package finds it:
    ``$TWTML_CONFIG``, then ``./application.conf``; the first that exists
    wins, and none gives no overrides."""
    candidates = []
    env_path = os.environ.get("TWTML_CONFIG", "")
    if env_path:
        candidates.append(env_path)
    candidates.append(os.path.join(os.getcwd(), "application.conf"))
    for path in candidates:
        if os.path.isfile(path):
            with open(path, encoding="utf-8") as fh:
                return parse_conf_text(fh.read())
    return {}


# attribute -> type, for every key of reference.conf but the OAuth keys
_TYPES: dict[str, type] = {
    "lightning": str, "twtweb": str, "seconds": int, "stepSize": float,
    "numIterations": int, "miniBatchFraction": float, "numRetweetBegin": int,
    "numRetweetEnd": int, "numTextFeatures": int, "backend": str, "source": str,
    "replayFile": str, "replaySpeed": float, "batchBucket": int, "tokenBucket": int,
    "l2Reg": float, "convergenceTol": float, "modelWatch": str, "wire": str,
    "featurizeNative": str, "wireAssemble": str, "webTimeout": float,
    "maxQueueRows": int, "shedPolicy": str, "checkpointDir": str,
    "checkpointEvery": int, "journal": str, "journalMaxMb": int, "history": str,
    "trace": str, "traceMaxMb": int, "blackbox": str, "faultEvery": int,
    "chaos": str, "recycleAfterMb": int, "sentinel": str, "sentinelRollbacks": int,
    "sentinelWindow": int, "modelWatchWindow": int, "freshness": str,
    "freshnessSloMs": float, "dtype": str, "hashOn": str, "ingest": str,
    "blockWire": str, "historyMaxMb": int, "perfGuard": str,
    "perfGuardRatio": float, "profileDir": str, "superBatch": int,
    "wirePack": str, "wireCodec": str, "elastic": str, "elasticEvictTicks": int,
    "elasticEvictSkewMs": float, "elasticRejoin": str, "tenants": int,
    "tenantKey": str, "servePort": int, "serveBatchRows": int,
    "serveMaxWaitMs": float, "serveDepth": int, "servePromoteEvery": float,
    "routerPort": int, "replicas": str, "routePolicy": str, "abtest": str,
    "servingStaleSloS": float, "coordinator": str, "numProcesses": int,
    "processId": int,
}

# short aliases of the JAX parser (the reference's own flags)
_SHORT = {
    "-l": "lightning", "-w": "twtweb", "-s": "seconds", "-p": "stepSize",
    "-i": "numIterations", "-b": "miniBatchFraction", "-B": "numRetweetBegin",
    "-E": "numRetweetEnd", "-f": "numTextFeatures",
}

# values the JAX parser validates, and how: a tuple is the allowed set, a
# callable the check on the parsed number
_VALID = {
    "backend": BACKENDS, "source": SOURCES, "modelWatch": ON_OFF,
    "wire": ("auto", "ragged", "padded"), "featurizeNative": MODES,
    "wireAssemble": MODES, "shedPolicy": SHED_POLICIES,
    "journal": MODES, "journalMaxMb": lambda v: v > 0, "history": MODES,
    "historyMaxMb": lambda v: v > 0, "perfGuard": ("warn", "off"),
    "perfGuardRatio": lambda v: v > 1.0, "blackbox": ON_OFF, "sentinel": ON_OFF,
    "freshness": ON_OFF, "freshnessSloMs": lambda v: v >= 0,
    "hashOn": ("device", "host"), "ingest": ("object", "block"),
    "blockWire": MODES, "wirePack": ("auto", "stacked", "group"),
    "wireCodec": ("auto", "off", "dict"), "elastic": ON_OFF,
    "elasticRejoin": ON_OFF, "tenants": lambda v: v >= 1,
    "tenantKey": ("hash", "lang"), "serveBatchRows": lambda v: v >= 1,
    "serveDepth": lambda v: v >= 1, "abtest": ON_OFF,
    "routePolicy": ("p99", "hash"), "servingStaleSloS": lambda v: v >= 0,
}

# the serving and router flags (apps/serve.py, apps/router.py), every one
# ported (--abtest on serves a tenant stack: serving/abtest.py)
SERVE_FLAGS = ("servePort", "serveBatchRows", "serveMaxWaitMs", "serveDepth",
               "servePromoteEvery", "routerPort", "replicas", "routePolicy",
               "abtest", "servingStaleSloS")


class ConfArguments:
    """The knobs of the port's linear-regression app; attribute names are
    the flags' camelCase names, as in the JAX package."""

    def __init__(self) -> None:
        conf = _load_defaults()
        conf.update(_load_application_conf())
        self.appName = "twtml-tpu"  # the JAX package's ConfArguments default
        for attr, kind in _TYPES.items():
            setattr(self, attr, kind(conf[attr]))
        # --master: local, local[N] or local[*] run on one host (the JAX
        # package's default); twtml://host:port names a multi-host group
        self.master: str = "local[*]"
        for key in _OAUTH_KEYS:
            if conf.get(key, ""):
                set_property("twitter4j.oauth." + key, conf[key])

    def setAppName(self, name: str) -> "ConfArguments":
        self.appName = name
        return self

    def usage(self) -> str:
        return f"""Usage: {self.appName} [options]
  -m, --master <master_url>                    local, local[N] or local[*]: one host (local[N] > 1
                                               on --backend cpu needs data parallelism, not
                                               ported); twtml://host:port: multi-host, not
                                               ported; other schemes are refused. Default: {self.master}
  -n, --name <name>                            A name of your application.
  -C, --consumerKey <consumerKey>              Twitter's consumer key
  -S, --consumerSecret <consumerSecret>        Twitter's consumer secret
  -A, --accessToken <accessToken>              Twitter's access token
  -T, --accessTokenSecret <accessTokenSecret>  Twitter's access token secret
  -l, --lightning <lightning_url>              Default: {self.lightning}
  -w, --twtweb <twtweb_url>                    Default: {self.twtweb}
  -s, --seconds <integer number>               Micro-batch interval; 0 or below = back to back
                                               (one --batchBucket of tweets a batch). Default: {self.seconds}
  --source <replay|synthetic|twitter>          twitter: the live stream, OAuth from -C/-S/-A/-T or
                                               application.conf. Default: {self.source}
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
  -b, --miniBatchFraction <float>              Bernoulli mini-batch of each iteration (the JAX
                                               package's threefry masks, bit for bit); below 1 the
                                               step runs as torch ops. Default: {self.miniBatchFraction}
  -f, --numTextFeatures <int>                  Default: {self.numTextFeatures}
  -B, --numRetweetBegin <int>                  Default: {self.numRetweetBegin}
  -E, --numRetweetEnd <int>                    Default: {self.numRetweetEnd}
  --l2Reg <float>                              Default: {self.l2Reg}
  --convergenceTol <float>                     Default: {self.convergenceTol}
  --dtype <float32|bfloat16|float64>           Weight and step dtype: float32 runs the fused
                                               kernel, bfloat16 the torch step; float64 runs
                                               on --backend cpu only. Default: {self.dtype}
  --modelWatch <on|off>                        In-step quality vector. Default: {self.modelWatch}
  --wire <auto|ragged|padded>                  Units wire: ragged ships the rows' units concatenated
                                               with uint16 length deltas in ONE packed buffer (one
                                               H2D copy; the step re-pads on the device), padded
                                               ships a [B, L] buffer and four more arrays. auto =
                                               ragged back to back (--seconds 0), padded under a
                                               wall clock. Default: {self.wire}
  --ingest <object|block>                      Replay/live ingest: per-tweet Status objects, or
                                               columnar blocks from the native C parser
                                               (native/tweetjson.cpp; --source replay or twitter,
                                               --hashOn device; replays as fast as it parses).
                                               Default: {self.ingest}
  --blockWire <auto|on|off>                    --ingest block's parser: on = the zero-copy wire
                                               emitter (uint8 units when every row is ASCII), off =
                                               the legacy C parser; auto = on iff the wire is
                                               ragged. The same batches either way. Default: {self.blockWire}
  --wireCodec <auto|off|dict>                  dict digram-codes the packed ragged wire's uint8
                                               units on the host (native/wirecodec.cpp) and decodes
                                               them on the device; uint16 units and incompressible
                                               batches ship raw (wire.codec_fallbacks). Needs the
                                               ragged wire; auto = off. Default: {self.wireCodec}
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
  --history <auto|on|off>                      Telemetry historian: CRC-framed time-series segments
                                               under <checkpointDir>/history, sampled at the stats
                                               publish (host views only); auto = on iff
                                               --checkpointDir. Default: {self.history}
  --historyMaxMb <int MB>                      Historian disk ceiling; the oldest segments are
                                               dropped past it. Default: {self.historyMaxMb}
  --perfGuard <warn|off>                       Cross-run stage regression sentinel against the
                                               baseline.json a clean shutdown stamps; warn-only.
                                               Default: {self.perfGuard}
  --perfGuardRatio <float>                     Sustained-regression threshold. Default: {self.perfGuardRatio}
  --hashOn <device|host>                       Bigram hashing in the device step, or on the host
                                               (native/fasthash.cpp; padded wire only); the same
                                               features either way. Default: {self.hashOn}
  --profileDir <path>                          torch.profiler trace (Chrome-trace JSON; CUDA
                                               activity on --backend cuda) of the stream.
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

  --superBatch <int K>                         Back to back (--seconds 0), with pinned --batchBucket
                                               and --tokenBucket: K batches a step_many dispatch
                                               (one CUDA graph replay on the card); each batch is
                                               reported on its own. Default: {self.superBatch}
  --wirePack <auto|stacked|group>              The superbatch's wire: stacked arrays, or (group,
                                               ragged wire only) one packed buffer a group; auto =
                                               stacked, or group under --wireCodec dict (stacked
                                               with the codec exits). Default: {self.wirePack}
  --tenants <int M>                            The tenant plane (parallel/tenants.py): M models
                                               on one wire, rows routed on the host, one launch
                                               of the step a tenant and ONE fetch a tick; each
                                               tenant bitwise a standalone learner on its rows.
                                               Checkpoints hold the [M, F+4] stack. Default: {self.tenants}
  --tenantKey <hash|lang>                      Tenant routing key: hash = SplitMix64 of each
                                               row's units (an A/B split); lang = the script of
                                               its widest code unit (needs --hashOn device).
                                               Default: {self.tenantKey}

  Serving (python -m twtml_tpu_torch.apps.serve) and its fleet router
  (python -m twtml_tpu_torch.apps.router):
  --servePort <int>                            Port of the serve entry point's web server (the
                                               dashboard and the POST /api/predict front door).
                                               Default: {self.servePort}
  --serveBatchRows <int rows>                  Coalescer: dispatch a predict batch once this
                                               many rows are admitted (the padded row bucket;
                                               a larger request is refused). Default: {self.serveBatchRows}
  --serveMaxWaitMs <float ms>                  Coalescer: dispatch a partial batch once the
                                               oldest admitted request has waited this long.
                                               Default: {self.serveMaxWaitMs}
  --serveDepth <int>                           Predict batches in flight (pipelined result
                                               fetches). Default: {self.serveDepth}
  --servePromoteEvery <float seconds>          Poll --checkpointDir this often; a new verified
                                               checkpoint stamped ok/warn hot-swaps in between
                                               dispatches, alert refuses. Default: {self.servePromoteEvery}
  --servingStaleSloS <float s>                 Warn-only staleness SLO on the served snapshot's
                                               age (a flight-recorder event and a counter a
                                               breach episode); 0 = none. Default: {self.servingStaleSloS}
  --abtest <on|off>                            Champion/challenger serving over a --tenants M >= 2
                                               checkpoint (serving/abtest.py): every batch
                                               mirrored to the M variants, the champion answers,
                                               challengers are shadow-scored; a better-stamped
                                               challenger is promoted unless its stamp is alert
                                               (refused, counted). Default: {self.abtest}
  --routerPort <int>                           Port of the router's front door (POST
                                               /api/predict forwarded, GET /api/fleet live).
                                               Default: {self.routerPort}
  --replicas <url,url,...>                     The router's serve replicas (base URLs), health-
                                               checked through GET /api/serving; a failing one
                                               is ejected behind a jittered backoff and its
                                               traffic retried on the others.
  --routePolicy <p99|hash>                     p99: the healthy replica with the lowest rolling
                                               p99 x (in flight + 1); hash: consistent hashing
                                               of the request body (64 vnodes a replica), so a
                                               key sticks to one replica. Default: {self.routePolicy}

  Multi-host (a lockstep group of processes, one model):
  --coordinator <host:port> --numProcesses <N> --processId <I>, or
  --master twtml://host:port with the other two. --backend cpu (or ranks that
  share a card) joins over gloo, one card a rank over nccl.
  --elastic <off|on>          Elastic lockstep membership (the linear and logistic
                              apps): a dead or evicted host SHRINKS the group (the
                              survivors re-form at an epoch boundary, restore the
                              lead's verified checkpoint and adopt the departed
                              intake shards) instead of aborting; a dead lead is
                              replaced by the lowest live uid; a recovered host
                              REJOINS at the next boundary. An elastic process
                              leaves through a hard exit. Default: {self.elastic}
  --elasticEvictTicks <int>   Evict a host the sideband names gating for this many
                              consecutive ticks (skew over --elasticEvictSkewMs);
                              0 = never. Default: {self.elasticEvictTicks}
  --elasticEvictSkewMs <float>  Least tick skew (ms) that counts toward
                              --elasticEvictTicks. Default: {self.elasticEvictSkewMs}
  --elasticRejoin <off|on>    Whether the lead admits parked or restarted hosts back
                              at epoch boundaries. Default: {self.elasticRejoin}
  -h, --help
"""

    def printUsage(self, exit_code: int) -> None:
        print(self.usage(), file=sys.stderr if exit_code else sys.stdout)
        raise SystemExit(exit_code)

    def parse(self, args: list[str]) -> "ConfArguments":
        """Apply ``args`` (flag value pairs); an unknown flag, a missing or
        malformed value, or one the JAX parser refuses prints the usage and
        exits 1."""
        i = 0
        while i < len(args):
            flag = args[i]
            if flag in ("-h", "--help"):
                self.printUsage(0)
            if i + 1 >= len(args):
                self.printUsage(1)
            value = args[i + 1]
            i += 2
            if flag in ("--master", "-m"):
                self.master = value
            elif flag in ("--name", "-n"):
                self.setAppName(value)
            elif flag in ("--consumerKey", "-C"):
                set_property("twitter4j.oauth.consumerKey", value)
            elif flag in ("--consumerSecret", "-S"):
                set_property("twitter4j.oauth.consumerSecret", value)
            elif flag in ("--accessToken", "-A"):
                set_property("twitter4j.oauth.accessToken", value)
            elif flag in ("--accessTokenSecret", "-T"):
                set_property("twitter4j.oauth.accessTokenSecret", value)
            else:
                attr = _SHORT.get(flag) or (flag[2:] if flag.startswith("--") else "")
                if attr not in _TYPES:
                    self.printUsage(1)
                try:
                    setattr(self, attr, _TYPES[attr](value))
                except ValueError:
                    self.printUsage(1)
        for attr, rule in _VALID.items():
            value = getattr(self, attr)
            if not (rule(value) if callable(rule) else value in rule):
                self.printUsage(1)
        return self

    def multihost(self) -> "tuple[str, int, int] | None":
        """(coordinator, num_processes, process_id) when a multi-host group is
        requested, None for a single-host run: the JAX package's rule. Call
        after ``validate_master``, which folds a ``twtml://`` master in.
        Half-given coordinates, fewer than 2 processes or an id out of range
        exit."""
        if not self.coordinator:
            if self.numProcesses > 0 or self.processId >= 0:
                raise SystemExit("--numProcesses/--processId need --coordinator "
                                 "host:port (or --master twtml://host:port)")
            return None
        if self.numProcesses < 2 or self.processId < 0:
            raise SystemExit("--coordinator requires --numProcesses >= 2 and "
                             "--processId >= 0 (one unique id per process)")
        if self.processId >= self.numProcesses:
            raise SystemExit(f"--processId {self.processId} out of range for "
                             f"--numProcesses {self.numProcesses}")
        return self.coordinator, self.numProcesses, self.processId

    def effective_wire(self) -> str:
        """Resolve ``--wire auto`` by the JAX package's rule
        (``twtml_tpu/config.py`` ``effective_wire``): ragged for a
        back-to-back stream; padded under a wall clock (``--seconds > 0``),
        where intervals are latency-bound and wire bytes do not bind.
        Host hashing ships hashed tokens, which only the padded wire
        carries. Explicit ``ragged``/``padded`` wins (ragged with ``--hashOn
        host`` is refused where the source is built)."""
        if self.wire != "auto":
            return self.wire
        return "padded" if self.hashOn != "device" or self.seconds > 0 else "ragged"

    def effective_block_wire(self) -> bool:
        """Resolve ``--blockWire`` by the JAX package's rule: whether block
        sources parse through the zero-copy wire emitter. ``auto`` follows
        the effective wire (the emitter gives the ragged wire's units; the
        padded wire keeps the legacy parser); explicit ``on``/``off`` wins.
        The batches are the same either way."""
        if self.blockWire != "auto":
            return self.blockWire == "on"
        return self.effective_wire() == "ragged"

    def effective_wire_pack(self) -> str:
        """Resolve ``--wirePack auto`` by the JAX package's rule: the
        stacked superbatch wire, but the group wire under ``--wireCodec
        dict`` (the codec rides the packed one-buffer forms);
        ``--wirePack stacked`` with the codec raises ``ValueError``, since
        it would ship the group's batches uncoded. Explicit ``group``/
        ``stacked`` wins otherwise."""
        if self.effective_wire_codec() == "dict":
            if self.wirePack == "stacked":
                raise ValueError(
                    "--wirePack stacked contradicts --wireCodec dict: the "
                    "codec rides the packed one-buffer wire (use "
                    "--wirePack group, or drop the codec)"
                )
            return "group"
        if self.wirePack != "auto":
            return self.wirePack
        return "stacked"

    def effective_wire_codec(self) -> str:
        """Resolve ``--wireCodec`` by the JAX package's rule: ``auto`` and
        ``off`` are off; ``dict`` needs the ragged raw-units wire, and with
        another wire raises ``ValueError``."""
        if self.wireCodec in ("off", "auto"):
            return "off"
        if self.effective_wire() != "ragged":
            raise ValueError(
                "--wireCodec dict needs the ragged raw-units wire "
                "(--wire ragged, or auto with --hashOn device and "
                "--seconds 0)"
            )
        return "dict"

    def effective_journal(self) -> bool:
        """Resolve ``--journal auto`` by the JAX package's rule: on exactly
        when ``--checkpointDir`` is set (the replay cursor lives in verified
        checkpoint meta). Explicit ``on``/``off`` wins; ``on`` without a
        checkpoint directory is refused where the journal is installed."""
        if self.journal != "auto":
            return self.journal == "on"
        return bool(self.checkpointDir)

    def effective_history(self) -> bool:
        """Resolve ``--history auto`` by the same rule: the historian's
        segments and the perfGuard baseline live under ``--checkpointDir``.
        ``on`` without one is refused where the historian is installed."""
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

    def local_shards(self) -> int | None:
        """The N of a ``local[N]`` master; None for ``local`` and
        ``local[*]`` (the JAX package's ``local_shards``)."""
        m = self.master
        if m.startswith("local[") and m.endswith("]"):
            inner = m[len("local["):-1]
            if inner != "*":
                try:
                    return max(1, int(inner))
                except ValueError:
                    return None
        return None

    def validate_master(self) -> None:
        """The JAX package's ``validate_master``: ``local``/``local[N]`` stay
        single-host; ``twtml://host:port`` fills ``--coordinator`` (a
        multi-host group, ``multihost``); any other
        scheme, the reference's ``spark://`` among them, exits."""
        m = self.master
        if m == "local" or (m.startswith("local[") and m.endswith("]")):
            return
        if m.startswith("twtml://"):
            addr = m[len("twtml://"):].rstrip("/")
            if not addr:
                raise SystemExit("--master twtml:// needs host:port")
            if self.coordinator and self.coordinator != addr:
                raise SystemExit(f"--master {m} conflicts with --coordinator "
                                 f"{self.coordinator}")
            self.coordinator = addr
            return
        raise SystemExit(
            f"unsupported --master {m!r}: use local[N] for single-host, or "
            "twtml://host:port (equivalently --coordinator host:port "
            "--numProcesses N --processId I) for a multi-host group"
        )
