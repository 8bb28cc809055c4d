"""The port's parser against the JAX package's (``twtml_tpu/config.py``).

- Every flag and short alias of the JAX parser parses in the port at the
  JAX package's default value, sets what the JAX parser sets, and selects
  the single-host path (``validate_master`` and ``check_ported`` pass).
  ``--backend`` is the one deliberate difference (cuda|cpu).
- The README's command lines of the JAX app, with the module renamed,
  parse; the line that runs one host on the fixture runs on ``--backend
  cpu`` and prints the JAX app's lines.
- A value that needs a feature the port has not ported raises
  ``NotImplementedError`` naming its ROADMAP item; ``spark://`` is refused
  as the JAX package refuses it; ``local[N]`` is a no-op on the card and
  needs A10 above 1 on the CPU.
- ``--seconds`` below 0 and negative buckets parse as in the JAX package,
  and values the JAX parser refuses exit in both.
"""

import ast
import contextlib
import io
import os
import re

import jax
import pytest

from twtml_tpu import config as jax_config
from twtml_tpu.config import ConfArguments as JaxConf
from twtml_tpu_torch import config as port_config
from twtml_tpu_torch.apps import common
from twtml_tpu_torch.apps import linear_regression as app
from twtml_tpu_torch.config import SERVE_FLAGS, ConfArguments

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DATA = os.path.join(REPO, "tests", "data", "tweets.jsonl")
CLOSED = "http://127.0.0.1:9"
QUIET = ["--lightning", CLOSED, "--twtweb", CLOSED, "--webTimeout", "0.2"]
NOW_MS = "1700000000000"


@pytest.fixture(autouse=True)
def restore_properties():
    """Both packages' property tables as they were before each test: the
    OAuth flags parsed here set ``twitter4j.oauth.*`` in both, and a later
    test in the same process that measures the live source without
    credentials (tests/test_bench_suite.py) would otherwise find them and
    try the real endpoint."""
    saved = (dict(jax_config._SYSTEM_PROPERTIES), dict(port_config._SYSTEM_PROPERTIES))
    yield
    for table, before in zip((jax_config._SYSTEM_PROPERTIES, port_config._SYSTEM_PROPERTIES),
                             saved):
        table.clear()
        table.update(before)


def _jax_parser_flags() -> list[str]:
    """Every flag string the JAX parser's ``parse`` matches, from its AST."""
    tree = ast.parse(open(jax_config.__file__, encoding="utf-8").read())
    (parse,) = [n for n in ast.walk(tree) if isinstance(n, ast.FunctionDef)
                and n.name == "parse"]
    flags = {n.value for n in ast.walk(parse) if isinstance(n, ast.Constant)
             and isinstance(n.value, str) and re.fullmatch(r"--?[A-Za-z][A-Za-z0-9]*", n.value)}
    return sorted(flags - {"-h", "--help"})


JAX_FLAGS = _jax_parser_flags()
SHORT = {"-m": "--master", "-n": "--name", "-C": "--consumerKey", "-S": "--consumerSecret",
         "-A": "--accessToken", "-T": "--accessTokenSecret", "-l": "--lightning",
         "-w": "--twtweb", "-s": "--seconds", "-p": "--stepSize", "-i": "--numIterations",
         "-b": "--miniBatchFraction", "-B": "--numRetweetBegin", "-E": "--numRetweetEnd",
         "-f": "--numTextFeatures"}
OAUTH = ("--consumerKey", "--consumerSecret", "--accessToken", "--accessTokenSecret")


def test_the_jax_parser_flags_are_all_found():
    assert len(JAX_FLAGS) == 92
    assert {"--master", "-m", "--dtype", "--superBatch", "--servePort", "-T"} <= set(JAX_FLAGS)


def default_value(long_flag: str) -> str:
    """The JAX package's default of a flag, as its command line spells it."""
    if long_flag == "--name":
        return "a-run"
    if long_flag in OAUTH:
        return "key-" + long_flag[2:]
    return str(getattr(JaxConf(), long_flag[2:]))


@pytest.mark.parametrize("flag", [f for f in JAX_FLAGS if f != "--backend"])
def test_every_jax_flag_parses_at_its_jax_default(flag):
    long_flag = SHORT.get(flag, flag)
    argv = [flag, default_value(long_flag)]
    ours, theirs = ConfArguments().parse(argv), JaxConf().parse(argv)
    if long_flag == "--name":
        assert ours.appName == theirs.appName() == "a-run"
    elif long_flag in OAUTH:
        key = "twitter4j.oauth." + long_flag[2:]
        assert port_config.get_property(key) == jax_config.get_property(key) == argv[1]
    for attr in vars(ours):
        if attr not in ("appName", "backend"):
            assert getattr(ours, attr) == getattr(theirs, attr), attr
    ours.validate_master()
    ours.check_ported()
    assert ours.effective_wire() == theirs.effective_wire()


def test_the_backend_stays_the_one_deliberate_difference():
    assert ConfArguments().parse(["--backend", "cpu"]).backend == "cpu"
    with pytest.raises(SystemExit) as exc:
        ConfArguments().parse(["--backend", "tpu"])
    assert exc.value.code == 1


def test_the_usage_names_every_jax_flag():
    text = ConfArguments().usage()
    missing = [f for f in JAX_FLAGS if not re.search(re.escape(f) + r"\b", text)]
    assert not missing


# ---- the README's JAX command lines, module renamed ---------------------------

def _readme_lines() -> list[list[str]]:
    text = open(os.path.join(REPO, "README.md"), encoding="utf-8").read().replace("\\\n", " ")
    out = []
    for line in text.splitlines():
        if line.strip().startswith("python -m twtml_tpu.apps.linear_regression"):
            argv = line.split("#")[0].split()[3:]
            # the one deliberate difference: the port's card is cuda
            out.append(["cuda" if a == "tpu" else a for a in argv])
    return out


README_LINES = _readme_lines()
# the ROADMAP item a README line needs, by the flag that needs it: the
# elastic runtime's (the lockstep runtime, A10a, took the twtml:// lines)
NEEDS = {"--elastic": "A10b"}


def test_the_readme_has_its_jax_command_lines():
    assert len(README_LINES) >= 10
    assert ["--seconds", "0", "--wire", "ragged", "--master", "local[1]"] == README_LINES[2][4:]


@pytest.mark.parametrize("argv", README_LINES, ids=lambda a: " ".join(a[4:])[:60])
def test_readme_command_lines_parse_in_the_port(argv):
    conf = ConfArguments().parse(argv)
    JaxConf().parse([("tpu" if a == "cuda" else a) for a in argv])
    items = [item for key, item in NEEDS.items() if key in argv]
    conf.validate_master()
    if items:
        with pytest.raises(NotImplementedError, match=f"ROADMAP {items[0]}"):
            conf.check_ported()
    else:
        conf.check_ported()


def test_readme_local_1_line_runs_on_the_cpu_with_the_jax_apps_lines(monkeypatch, capsys):
    """README.md's ``--seconds 0 --wire ragged --master local[1]`` line, with
    the module renamed and ``--backend cpu``, prints the JAX app's lines."""
    from twtml_tpu.apps import linear_regression as jax_app

    monkeypatch.setenv("TWTML_NOW_MS", NOW_MS)
    argv = README_LINES[2] + ["--backend", "cpu", *QUIET]
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        totals = app.run(ConfArguments().parse(argv))
    lines = [ln for ln in out.getvalue().splitlines() if ln.startswith("count:")]
    jax.devices()
    jax_app.run(JaxConf().parse(argv))
    jax_lines = [ln for ln in capsys.readouterr().out.splitlines() if ln.startswith("count:")]
    assert lines == jax_lines and totals["count"] == 6


# ---- values that need an unported feature -------------------------------------------

# the multi-host values the port refused naming ROADMAP A10 before it ported
# the lockstep runtime (A10a): --elastic on still raises, naming A10b; the
# others are the feature's now
UNPORTED = [
    (["--numProcesses", "2"], "A10"),
    (["--processId", "0"], "A10"), (["--coordinator", "host:9"], "A10"),
    (["--elastic", "on"], "A10"), (["--master", "twtml://host:9"], "A10"),
    (["--tenants", "2", "--coordinator", "host:9"], "A10"),
]


def _multihost_outcome(conf):
    conf.validate_master()
    try:
        return conf.multihost()
    except SystemExit as exc:
        return ("exit", str(exc))


@pytest.mark.parametrize("argv,item", UNPORTED, ids=lambda v: " ".join(v) if isinstance(v, list) else v)
def test_unported_values_raise_naming_their_item(argv, item):
    """``--elastic on`` raises naming ROADMAP A10b (the rest of ``item``);
    the group coordinates pass ``select_backend`` and resolve as the JAX
    package's ``multihost`` resolves them (half-given ones exit)."""
    conf = ConfArguments().parse(argv)
    theirs = JaxConf().parse(argv)  # the JAX parser takes the same value
    if conf.elastic == "on":
        with pytest.raises(NotImplementedError, match=f"ROADMAP {item}b"):
            common.select_backend(conf)
        return
    common.select_backend(conf)
    assert _multihost_outcome(conf) == _multihost_outcome(theirs)


@pytest.mark.parametrize("argv", [
    ["--coordinator", "h:9", "--numProcesses", "2", "--processId", "1"],
    ["--master", "twtml://h:9/", "--numProcesses", "4", "--processId", "0"],
    ["--master", "twtml://h:9", "--coordinator", "h:9", "--numProcesses", "2",
     "--processId", "0"],
    ["--coordinator", "h:9", "--numProcesses", "2", "--processId", "2"],
    ["--coordinator", "h:9", "--numProcesses", "1", "--processId", "0"],
], ids=lambda a: " ".join(a))
def test_multihost_coordinates_resolve_as_the_jax_package_does(argv):
    assert _multihost_outcome(ConfArguments().parse(argv)) == _multihost_outcome(
        JaxConf().parse(argv))


# the paths ported since: the live source, host hashing, the profiler, the
# superbatch and its wires, the tenant plane, block ingest and the digram codec
NOW_PORTED = [["--wireCodec", "dict"], ["--ingest", "block"], ["--ingest", "block",
              "--blockWire", "on"], ["--wireCodec", "dict", "--seconds", "0",
              "--superBatch", "4"],
              ["--hashOn", "host"], ["--source", "twitter"], ["--profileDir", "/tmp/prof"],
              ["--superBatch", "4"], ["--superBatch", "8", "--wirePack", "group"],
              ["--wirePack", "stacked"], ["--tenants", "2"],
              ["--tenants", "4", "--tenantKey", "lang"], ["--tenants", "1", "--tenantKey", "lang"]]


@pytest.mark.parametrize("argv", NOW_PORTED, ids=" ".join)
def test_ported_host_paths_pass_check_ported(argv):
    conf = ConfArguments().parse(argv)
    JaxConf().parse(argv)
    conf.check_ported()


# the serving plane and its router (ROADMAP A8), and champion/challenger
# serving on a tenant stack (--abtest on, A9)
SERVE_VALUES = [
    ["--servePort", "9000"], ["--serveBatchRows", "64"], ["--serveMaxWaitMs", "1.5"],
    ["--serveDepth", "2"], ["--servePromoteEvery", "1.0"], ["--routerPort", "9001"],
    ["--replicas", "http://a:1"], ["--routePolicy", "hash"], ["--servingStaleSloS", "5"],
    ["--abtest", "off"], ["--abtest", "on"],
]


@pytest.mark.parametrize("argv", SERVE_VALUES, ids=" ".join)
def test_serve_flags_pass_check_ported(argv):
    conf = ConfArguments().parse(argv)
    JaxConf().parse(argv)
    common.select_backend(conf)


def test_every_serve_flag_is_held():
    held = {a[0][2:] for a in SERVE_VALUES} | {a[0][2:] for a, _ in UNPORTED}
    assert set(SERVE_FLAGS) <= held


def test_the_app_refuses_an_unported_value_before_it_builds_anything(monkeypatch):
    monkeypatch.setattr(common, "build_model",
                        lambda conf: pytest.fail("built a model for an unported value"))
    with pytest.raises(NotImplementedError, match="ROADMAP A10"):
        app.run(ConfArguments().parse(["--backend", "cpu", "--elastic", "on", *QUIET]))


def test_values_the_jax_package_ignores_on_this_path_pass():
    ConfArguments().parse(["--wirePack", "group", "--blockWire", "off",
                           "--elasticRejoin", "off", "--elasticEvictTicks", "3",
                           "--elasticEvictSkewMs", "10"]).check_ported()


@pytest.mark.parametrize("master,backend,outcome", [
    ("local", "cpu", None), ("local[1]", "cpu", None), ("local[*]", "cpu", None),
    ("local[4]", "cuda", None), ("local[2]", "cpu", "A10"),
])
def test_local_master_follows_the_jax_rule(master, backend, outcome):
    """``local[N]`` resolves by the JAX rule, ``min(N, devices)`` data
    shards: one process drives one device (the CPU or one card), so every
    N runs unsharded. (N > 1 on the CPU raised naming ``outcome``, A10,
    until the lockstep runtime was ported.)"""
    conf = ConfArguments().parse(["--master", master, "--backend", backend])
    assert conf.local_shards() == JaxConf().parse(["--master", master]).local_shards()
    common.select_backend(conf)


@pytest.mark.parametrize("master", ["spark://host:7077", "mesos://m:5050", "yarn"])
def test_cluster_masters_are_refused_as_in_the_jax_package(master):
    with pytest.raises(SystemExit, match="unsupported --master"):
        ConfArguments().parse(["--master", master]).validate_master()
    with pytest.raises(SystemExit, match="unsupported --master"):
        JaxConf().parse(["--master", master]).validate_master()


# ---- values the JAX parser takes or refuses ---------------------------------------------

@pytest.mark.parametrize("argv", [["--seconds", "-1"], ["--batchBucket", "-4"],
                                  ["--tokenBucket", "-2"], ["-s", "-3", "--batchBucket", "-1"]])
def test_negative_seconds_and_buckets_parse_as_in_the_jax_package(argv):
    ours, theirs = ConfArguments().parse(argv), JaxConf().parse(argv)
    for attr in ("seconds", "batchBucket", "tokenBucket"):
        assert getattr(ours, attr) == getattr(theirs, attr)
    assert ours.effective_wire() == theirs.effective_wire()
    assert ours.effective_max_queue_rows() == theirs.effective_max_queue_rows()


def test_negative_seconds_run_as_in_the_jax_app(monkeypatch, capsys):
    """``--seconds -1`` runs back to back on the fetch pipeline, draining
    the queue without a row cap, as the JAX app does: its lines."""
    from twtml_tpu.apps import linear_regression as jax_app

    monkeypatch.setenv("TWTML_NOW_MS", NOW_MS)
    argv = ["--source", "replay", "--replayFile", DATA, "--seconds", "-1",
            "--batchBucket", "4", "--backend", "cpu", "--master", "local[1]", *QUIET]
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        totals = app.run(ConfArguments().parse(argv))
    lines = [ln for ln in out.getvalue().splitlines() if ln.startswith("count:")]
    jax.devices()
    jax_app.run(JaxConf().parse(argv))
    jax_lines = [ln for ln in capsys.readouterr().out.splitlines() if ln.startswith("count:")]
    assert lines == jax_lines and totals["count"] == 6
    assert all(st["wire"] == "ragged" for st in totals["steps"])


@pytest.mark.parametrize("argv", [
    ["--hashOn", "gpu"], ["--ingest", "lines"], ["--wire", "x"], ["--blockWire", "1"],
    ["--wirePack", "x"], ["--wireCodec", "lz4"], ["--elastic", "maybe"],
    ["--elasticRejoin", "x"], ["--tenants", "0"], ["--tenantKey", "x"],
    ["--serveBatchRows", "0"], ["--serveDepth", "0"], ["--abtest", "x"],
    ["--routePolicy", "rr"], ["--servingStaleSloS", "-1"], ["--perfGuard", "x"],
    ["--historyMaxMb", "-1"], ["--superBatch", "x"], ["--numProcesses", "two"],
    ["--master"], ["--unknownFlag", "1"],
])
def test_values_the_jax_parser_refuses_exit_in_both(argv):
    with pytest.raises(SystemExit) as exc:
        ConfArguments().parse(argv)
    assert exc.value.code == 1
    with pytest.raises((SystemExit, ValueError)):
        JaxConf().parse(argv)


def test_app_name_defaults_to_the_jax_packages():
    """Without ``--name`` or ``setAppName`` the app name (the Lightning
    session of the k-means chart, the usage line) is the JAX parser's."""
    assert ConfArguments().appName == JaxConf().appName() == "twtml-tpu"
    assert ConfArguments().parse(["--name", "x"]).appName == JaxConf().parse(["--name", "x"]).appName()
