"""``application.conf`` layering in the port's parser (``twtml_tpu_torch/
config.py``) against the JAX package's (``twtml_tpu/config.py``): the file
``$TWTML_CONFIG`` names, else ``./application.conf``, over the packaged
defaults; its OAuth keys in the ``twitter4j.oauth.*`` property table; CLI
flags over the file. Both parsers read the same files in a temporary
working directory and must agree on every attribute and property."""

import pytest

from twtml_tpu import config as jax_config
from twtml_tpu.config import ConfArguments as JaxConf
from twtml_tpu_torch import config
from twtml_tpu_torch.apps import common
from twtml_tpu_torch.config import _TYPES, _VALID, ConfArguments

OAUTH = ("consumerKey", "consumerSecret", "accessToken", "accessTokenSecret")
# every key both parsers read from a file (backend differs by design:
# cuda|cpu in the port, auto|tpu|cpu in the JAX package)
SHARED = sorted(a for a in _TYPES if a != "backend")

# a valid value other than the default for the free-form and bounded keys
FREE = {
    "lightning": "http://127.0.0.1:3000", "twtweb": "http://127.0.0.1:8899",
    "replayFile": "tweets.jsonl", "checkpointDir": "ckpt", "trace": "run.trace",
    "chaos": "fetch:delay=0.1@3", "profileDir": "prof", "replicas": "http://a:1",
    "coordinator": "host:9", "dtype": "bfloat16",
}


def other_value(attr: str) -> str:
    """A value for ``attr`` that both parsers accept and that is not its
    default."""
    default = getattr(ConfArguments(), attr)
    if attr in FREE:
        return FREE[attr]
    rule = _VALID.get(attr)
    if isinstance(rule, tuple):
        return next(v for v in rule if v != default)
    kind = _TYPES[attr]
    if kind is int:
        return str(default + 3)
    return str(default + 1.5)


@pytest.fixture()
def workdir(tmp_path, monkeypatch):
    """A working directory of its own, no TWTML_CONFIG, and both property
    tables emptied for the test (restored after it)."""
    monkeypatch.chdir(tmp_path)
    monkeypatch.delenv("TWTML_CONFIG", raising=False)
    saved = dict(config._SYSTEM_PROPERTIES), dict(jax_config._SYSTEM_PROPERTIES)
    config._SYSTEM_PROPERTIES.clear()
    jax_config._SYSTEM_PROPERTIES.clear()
    yield tmp_path
    for table, old in zip((config._SYSTEM_PROPERTIES, jax_config._SYSTEM_PROPERTIES), saved):
        table.clear()
        table.update(old)


def both(argv=()):
    """(port conf, JAX conf, port properties, JAX properties) after each
    parser built and parsed ``argv``."""
    ours = ConfArguments().parse(list(argv))
    theirs = JaxConf().parse(list(argv))
    return ours, theirs, dict(config._SYSTEM_PROPERTIES), dict(jax_config._SYSTEM_PROPERTIES)


def assert_agree(ours, theirs):
    for attr in SHARED:
        assert getattr(ours, attr) == getattr(theirs, attr), attr


def test_three_keys_of_the_file_reach_the_port(workdir):
    """seconds 3, stepSize 0.5 and consumerKey "ck" in ./application.conf:
    the JAX parser reads them, and so does the port's (ROADMAP C2: it read
    only its defaults, 5, 0.005 and no key)."""
    (workdir / "application.conf").write_text('seconds = 3\nstepSize = 0.5\nconsumerKey = "ck"\n')
    ours, theirs, props, jax_props = both()
    assert (ours.seconds, ours.stepSize) == (theirs.seconds, theirs.stepSize) == (3, 0.5)
    assert props["twitter4j.oauth.consumerKey"] == jax_props["twitter4j.oauth.consumerKey"] == "ck"
    assert_agree(ours, theirs)


@pytest.mark.parametrize("attr", SHARED)
def test_each_key_of_the_file_reaches_both_parsers(workdir, attr):
    value = other_value(attr)
    (workdir / "application.conf").write_text(f'{attr}="{value}"\n')
    ours, theirs, _, _ = both()
    assert getattr(ours, attr) == _TYPES[attr](value)
    assert getattr(ours, attr) != _TYPES[attr](config._load_defaults()[attr])
    assert_agree(ours, theirs)


def write_all(path, seconds: int, key: str):
    path.write_text(
        "# every OAuth key and two numbers\n"
        f"seconds={seconds}  // inline comment\n"
        'stepSize="0.25"\n'
        + "".join(f'{k}="{key}-{k}"\n' for k in OAUTH)
    )


@pytest.mark.parametrize("layout", ["cwd", "env", "env-over-cwd", "missing-env-falls-to-cwd"])
def test_the_file_is_found_as_the_jax_package_finds_it(workdir, tmp_path_factory, monkeypatch,
                                                       layout):
    elsewhere = tmp_path_factory.mktemp("conf") / "site.conf"
    if layout in ("cwd", "env-over-cwd", "missing-env-falls-to-cwd"):
        write_all(workdir / "application.conf", 7, "cwd")
    if layout in ("env", "env-over-cwd"):
        write_all(elsewhere, 9, "env")
    if layout != "cwd":
        monkeypatch.setenv("TWTML_CONFIG", str(elsewhere))
    ours, theirs, props, jax_props = both()
    want_seconds, want_key = (7, "cwd") if layout in ("cwd", "missing-env-falls-to-cwd") else (9, "env")
    assert ours.seconds == theirs.seconds == want_seconds
    assert ours.stepSize == theirs.stepSize == 0.25
    assert props == jax_props == {f"twitter4j.oauth.{k}": f"{want_key}-{k}" for k in OAUTH}
    assert_agree(ours, theirs)


def test_the_first_file_found_wins_whole(workdir, tmp_path_factory, monkeypatch):
    """TWTML_CONFIG's file replaces ./application.conf; the two are not
    merged (a key only the cwd file sets stays at its default)."""
    (workdir / "application.conf").write_text('numIterations="7"\nseconds="2"\n')
    elsewhere = tmp_path_factory.mktemp("conf") / "site.conf"
    elsewhere.write_text('seconds="4"\n')
    monkeypatch.setenv("TWTML_CONFIG", str(elsewhere))
    ours, theirs, _, _ = both()
    assert (ours.seconds, ours.numIterations) == (theirs.seconds, theirs.numIterations) == (4, 50)


@pytest.mark.parametrize("argv", [
    ["-s", "1", "-p", "0.125", "-C", "cli-key"],
    ["--seconds", "0", "--stepSize", "0.5", "--consumerKey", "cli-key", "--hashOn", "device"],
])
def test_flags_override_the_file(workdir, argv):
    write_all(workdir / "application.conf", 7, "file")
    (workdir / "application.conf").write_text(
        (workdir / "application.conf").read_text() + 'hashOn="host"\n')
    ours, theirs, props, jax_props = both(argv)
    assert ours.seconds == theirs.seconds == int(argv[1])
    assert ours.stepSize == theirs.stepSize == float(argv[3])
    assert props == jax_props
    assert props["twitter4j.oauth.consumerKey"] == "cli-key"
    assert props["twitter4j.oauth.accessToken"] == "file-accessToken"
    assert ours.hashOn == theirs.hashOn == ("device" if "--hashOn" in argv else "host")
    assert_agree(ours, theirs)


def test_no_file_leaves_the_defaults_and_no_properties(workdir):
    ours, theirs, props, jax_props = both()
    assert props == jax_props == {}
    assert ours.seconds == 5 and ours.stepSize == 0.005
    assert_agree(ours, theirs)


def test_an_empty_oauth_key_sets_no_property(workdir):
    (workdir / "application.conf").write_text('consumerKey=""\naccessToken="tok"\n')
    _, _, props, jax_props = both()
    assert props == jax_props == {"twitter4j.oauth.accessToken": "tok"}


def test_check_ported_compares_with_the_packaged_defaults(workdir):
    """A value set in the file takes effect as the same flag would: the
    values the port runs pass from the file (the serve flags, ``--abtest
    on``, ``--wireCodec dict``, ``--ingest block`` and, since elastic
    membership (ROADMAP A10b) is ported, ``elastic="on"``), resolving as
    the JAX parser's."""
    (workdir / "application.conf").write_text(
        'servePort="9000"\nabtest="on"\nwireCodec="dict"\ningest="block"\nseconds="0"\n'
        'elastic="on"\n')
    conf, theirs, _, _ = both()
    assert (conf.servePort, conf.abtest, conf.wireCodec, conf.ingest) == (9000, "on", "dict",
                                                                        "block")
    assert (conf.effective_wire_codec(), conf.effective_block_wire()) == (
        theirs.effective_wire_codec(), theirs.effective_block_wire()) == ("dict", True)
    assert conf.elastic == theirs.elastic == "on"
    common.select_backend(conf)
    conf.elastic = "off"
    common.select_backend(conf)
