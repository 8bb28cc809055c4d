"""Configuration + CLI flags of the port's linear-regression app (counterpart
of a subset of ``twtml_tpu/config.py``).

Defaults come from the port's own ``resources/reference.conf``; flag names
and short aliases are the JAX package's. ``--backend`` takes ``cuda|cpu``
(default ``cuda``).
"""

from __future__ import annotations

import sys
from importlib import resources as _importlib_resources

BACKENDS = ("cuda", "cpu")
SOURCES = ("replay", "synthetic")


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
        self.stepSize: float = float(conf["stepSize"])
        self.numIterations: int = int(conf["numIterations"])
        self.miniBatchFraction: float = float(conf["miniBatchFraction"])
        self.numRetweetBegin: int = int(conf["numRetweetBegin"])
        self.numRetweetEnd: int = int(conf["numRetweetEnd"])
        self.numTextFeatures: int = int(conf["numTextFeatures"])
        self.backend: str = conf["backend"]
        self.source: str = conf["source"]
        self.replayFile: str = conf["replayFile"]
        self.batchBucket: int = int(conf["batchBucket"])
        self.l2Reg: float = float(conf["l2Reg"])
        self.convergenceTol: float = float(conf["convergenceTol"])
        self.modelWatch: str = conf["modelWatch"]

    def setAppName(self, name: str) -> "ConfArguments":
        self.appName = name
        return self

    def usage(self) -> str:
        return f"""Usage: {self.appName} [options]
  --source <replay|synthetic>                  Default: {self.source}
  --replayFile <path.jsonl>                    Tweets to replay with --source replay
  --backend <cuda|cpu>                         Device of the model. Default: {self.backend}
  --batchBucket <int>                          Source tweets per micro-batch (> 0). Default: {self.batchBucket}
  -p, --stepSize <float>                       Default: {self.stepSize}
  -i, --numIterations <int>                    Default: {self.numIterations}
  -b, --miniBatchFraction <float>              Default: {self.miniBatchFraction}
  -f, --numTextFeatures <int>                  Default: {self.numTextFeatures}
  -B, --numRetweetBegin <int>                  Default: {self.numRetweetBegin}
  -E, --numRetweetEnd <int>                    Default: {self.numRetweetEnd}
  --l2Reg <float>                              Default: {self.l2Reg}
  --convergenceTol <float>                     Default: {self.convergenceTol}
  --modelWatch <on|off>                        In-step quality vector. Default: {self.modelWatch}
  -h, --help
"""

    def printUsage(self, exit_code: int) -> None:
        print(self.usage(), file=sys.stderr if exit_code else sys.stdout)
        raise SystemExit(exit_code)

    def parse(self, args: list[str]) -> "ConfArguments":
        """Apply ``args`` (flag value pairs); an unknown flag, a missing or
        malformed value prints the usage and exits 1."""
        setters = {
            "--source": ("source", str),
            "--replayFile": ("replayFile", str),
            "--backend": ("backend", str),
            "--batchBucket": ("batchBucket", int),
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
            or self.batchBucket <= 0
        ):
            self.printUsage(1)
        return self
