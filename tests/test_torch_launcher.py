"""Port parity: the launch stack (``deepspeed_tpu_torch/launcher/launch.py``,
``runner.py``, ``multinode_runner.py``) against the JAX package's.

Hostfiles, resource filters and the world-info encoding are equal byte for
byte; every runner's argv is JAX's for the same inputs, the per-node
launcher's module name aside; ``resolve_node_rank`` gives JAX's rank (or
error) under the same environment and hostname; ``child_env`` keeps JAX's
keys and adds torch's ``MASTER_ADDR`` / ``MASTER_PORT``. Then the real
thing, in subprocesses that import no torch: the runner launching a script
that prints its environment (one node, and two through ``--launcher
local``), and SIGTERM to the per-node launcher ending its child's whole
tree.
"""

import json
import os
import signal
import subprocess
import sys
import tempfile
import time
from collections import OrderedDict

import pytest

from deepspeed_tpu.launcher import launch as jlaunch
from deepspeed_tpu.launcher import multinode_runner as jmr
from deepspeed_tpu.launcher import runner as jrunner
from deepspeed_tpu_torch.launcher import launch as tlaunch
from deepspeed_tpu_torch.launcher import multinode_runner as tmr
from deepspeed_tpu_torch.launcher import runner as trunner

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JAX_MODULE, PORT_MODULE = "deepspeed_tpu.launcher.launch", "deepspeed_tpu_torch.launcher.launch"


def _outcome(fn, *args):
    """(value, None) or (None, (exception class name, message))."""
    try:
        return fn(*args), None
    except (ValueError, RuntimeError) as e:
        return None, (type(e).__name__, str(e))


HOSTFILES = {
    "plain": "worker-0 slots=4\nworker-1 slots=4\n",
    "comments_and_blanks": "# pod\n\nworker-0 slots=8  # first\n   \nworker-1\nworker-2 slots=2 extra=1\n",
    "no_slots": "a\nb\nc\n",
    "torn": "worker-0 slots=4\nworker-1 slots=\n",
    "bad_slots": "worker-0 slots=four\n",
    "duplicate": "worker-0 slots=4\nworker-0 slots=2\n",
    "empty": "",
}


@pytest.mark.parametrize("name", sorted(HOSTFILES) + ["missing"])
def test_fetch_hostfile_equals_jax(tmp_path, name):
    path = str(tmp_path / "hostfile")
    if name != "missing":
        with open(path, "w") as f:
            f.write(HOSTFILES[name])
    got, want = _outcome(trunner.fetch_hostfile, path), _outcome(jrunner.fetch_hostfile, path)
    assert got == want
    if got[0] is not None:
        assert list(got[0].items()) == list(want[0].items())  # the order too


POOL = OrderedDict([("worker-0", 4), ("worker-1", 4), ("worker-2", 2)])
FILTERS = [
    ("", ""),
    ("worker-1", ""),
    ("worker-2@worker-0:0,2", ""),
    ("worker-1:3,1", ""),
    ("worker-9", ""),
    ("worker-0:7", ""),
    ("", "worker-1"),
    ("", "worker-0:0,1@worker-2:0,1"),
    ("", "worker-9"),
    ("worker-0", "worker-1"),
]


@pytest.mark.parametrize("include,exclude", FILTERS)
def test_parse_resource_filter_equals_jax(include, exclude):
    got = _outcome(trunner.parse_resource_filter, POOL, include, exclude)
    want = _outcome(jrunner.parse_resource_filter, POOL, include, exclude)
    assert got == want
    if got[0] is not None:
        active = got[0]
        assert trunner.encode_world_info(active) == jrunner.encode_world_info(want[0])
        assert trunner.decode_world_info(trunner.encode_world_info(active)) == \
            jrunner.decode_world_info(jrunner.encode_world_info(want[0]))


def _active():
    return OrderedDict([("node-0", [0]), ("node-1", [0, 1]), ("node-2", [0])])


def _node_cmd_for(runner_mod):
    info = runner_mod.encode_world_info(_active())
    return lambda rank_spec: runner_mod.build_node_command(rank_spec, 3, "node-0:29500", info, "train.py",
                                                           ["--x", "1", "--name=a b"])


def _port_spelling(cmds):
    return [[a.replace(JAX_MODULE, PORT_MODULE) for a in cmd] for cmd in cmds]


@pytest.mark.parametrize("name", sorted(jmr.RUNNERS))
def test_runner_argv_equals_jax_module_aside(tmp_path, name):
    env = {"DSTPU_FOO": "1", "NCCL_DEBUG": "INFO x"}
    hosts = tmp_path / "mv2_hosts"
    if name == "mvapich":
        jr = jmr.MVAPICHRunner("--foo 'a b'", env, hostfile_path=str(hosts))
        tr = tmr.MVAPICHRunner("--foo 'a b'", env, hostfile_path=str(hosts))
    else:
        jr, tr = jmr.get_runner(name, "--foo 'a b'", env), tmr.get_runner(name, "--foo 'a b'", env)
    want = jr.get_cmd(_active(), _node_cmd_for(jrunner))
    jax_hosts = hosts.read_text() if name == "mvapich" else None
    got = tr.get_cmd(_active(), _node_cmd_for(trunner))
    assert got == _port_spelling(want)
    assert PORT_MODULE in " ".join(got[0]) and JAX_MODULE + " " not in " ".join(got[0])
    assert tr.backend_exists() == jr.backend_exists()
    if name == "mvapich":
        assert hosts.read_text() == jax_hosts == "node-0\nnode-1\nnode-2\n"
        assert tr.env == jr.env


def test_mvapich_default_hostfile_is_a_file_per_runner(tmp_path, monkeypatch):
    """Two runners on one host write their own hostfiles under TMPDIR, not
    JAX's one fixed path."""
    monkeypatch.setenv("TMPDIR", str(tmp_path))
    monkeypatch.setattr(tempfile, "tempdir", None)
    a, b = tmr.MVAPICHRunner(), tmr.MVAPICHRunner()
    cmd_a = a.get_cmd(_active(), _node_cmd_for(trunner))[0]
    one = OrderedDict([("node-9", [0])])
    cmd_b = b.get_cmd(one, _node_cmd_for(trunner))[0]
    assert a.hostfile_path != b.hostfile_path
    assert {os.path.dirname(a.hostfile_path), os.path.dirname(b.hostfile_path)} == {str(tmp_path)}
    assert cmd_a[cmd_a.index("-hostfile") + 1] == a.hostfile_path
    assert cmd_b[cmd_b.index("-hostfile") + 1] == b.hostfile_path
    with open(a.hostfile_path) as fa, open(b.hostfile_path) as fb:
        assert (fa.read(), fb.read()) == ("node-0\nnode-1\nnode-2\n", "node-9\n")
    a.get_cmd(one, _node_cmd_for(trunner))  # a runner keeps its file across calls
    assert os.path.dirname(a.hostfile_path) == str(tmp_path) and len(os.listdir(tmp_path)) == 2


def test_get_runner_rejects_unknown_as_jax_does():
    assert sorted(tmr.RUNNERS) == sorted(jmr.RUNNERS)
    assert _outcome(tmr.get_runner, "slurm") == _outcome(jmr.get_runner, "slurm")


def test_build_node_command_is_jax_with_the_port_module():
    info = trunner.encode_world_info(_active())
    for spec in (0, 2, "mpi", "auto"):
        got = trunner.build_node_command(spec, 3, "h:1", info, "t.py", ["-a"])
        want = jrunner.build_node_command(spec, 3, "h:1", info, "t.py", ["-a"])
        assert got == _port_spelling([want])[0]


def test_exportable_env_swaps_the_tpu_prefixes_for_cuda_ones(monkeypatch):
    for k in list(os.environ):
        monkeypatch.delenv(k)
    env = {"DSTPU_A": "1", "PYTHONPATH": "p", "CUDA_VISIBLE_DEVICES": "0", "NCCL_DEBUG": "INFO",
           "TORCH_LOGS": "x", "JAX_PLATFORMS": "cpu", "XLA_FLAGS": "f", "HOME": "h"}
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    assert trunner._exportable_env() == {k: env[k] for k in ("DSTPU_A", "PYTHONPATH", "CUDA_VISIBLE_DEVICES",
                                                             "NCCL_DEBUG", "TORCH_LOGS")}
    shared = {k for k in jrunner._exportable_env() if k.startswith(("DSTPU_", "PYTHON"))}
    assert shared == {"DSTPU_A", "PYTHONPATH"}


RANK_CASES = [
    ("3", {}, None, ""),
    ("mpi", {"OMPI_COMM_WORLD_RANK": "2"}, None, ""),
    ("mpi", {"MV2_COMM_WORLD_RANK": "5"}, None, ""),
    ("mpi", {"PMI_RANK": "1", "PMIX_RANK": "4"}, None, ""),
    ("mpi", {"PMIX_RANK": "4"}, None, ""),
    ("mpi", {}, None, ""),
    ("auto", {}, "node-1", "two"),
    ("auto", {}, "node-9", "two"),
    ("auto", {}, "node10", "collide"),
    ("auto", {}, "node1.cluster.local", "collide"),
    ("auto", {}, "node1", "collide"),
    ("auto", {}, "node-0.pod.local", "fqdn"),
    ("auto", {}, "node-2", "fqdn"),
]
WORLDS = {"": OrderedDict(), "two": OrderedDict([("node-0", [0]), ("node-1", [0])]),
          "collide": OrderedDict([("node1", [0]), ("node10", [0])]),
          "fqdn": OrderedDict([("node-0", [0]), ("node-2.pod.local", [0])])}


@pytest.mark.parametrize("spec,env,hostname,world", RANK_CASES)
def test_resolve_node_rank_equals_jax(monkeypatch, spec, env, hostname, world):
    import socket

    for var in ("OMPI_COMM_WORLD_RANK", "MV2_COMM_WORLD_RANK", "PMI_RANK", "PMIX_RANK"):
        monkeypatch.delenv(var, raising=False)
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    if hostname is not None:
        monkeypatch.setattr(socket, "gethostname", lambda: hostname)
    info = trunner.encode_world_info(WORLDS[world])
    got, want = _outcome(tlaunch.resolve_node_rank, spec, info), _outcome(jlaunch.resolve_node_rank, spec, info)
    assert got == want


def test_child_env_keeps_jax_keys_and_adds_master_addr_port(monkeypatch):
    monkeypatch.setenv("KEEP_ME", "1")
    info = trunner.encode_world_info(_active())
    got = tlaunch.child_env(2, 3, "node-0:29511", info)
    want = jlaunch.child_env(2, 3, "node-0:29511", info)
    assert {k: got[k] for k in want} == want
    assert set(got) - set(want) == {"MASTER_ADDR", "MASTER_PORT"}
    assert (got["MASTER_ADDR"], got["MASTER_PORT"]) == ("node-0", "29511")
    assert (got["RANK"], got["WORLD_SIZE"], got["LOCAL_RANK"]) == ("2", "3", "0")
    assert got["KEEP_ME"] == "1"


_PRINT_ENV = """
import json, os
keys = ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT", "DSTPU_COORDINATOR",
        "DSTPU_NUM_PROCESSES", "DSTPU_PROCESS_ID", "DSTPU_WORLD_INFO")
with open(os.path.join({out!r}, "env-" + os.environ["RANK"] + ".json"), "w") as f:
    json.dump({{k: os.environ.get(k) for k in keys}}, f)
"""


def _env():
    return dict(os.environ, PYTHONPATH=REPO)


@pytest.mark.parametrize("hosts,launcher", [("localhost slots=1\n", "ssh"),
                                            ("node-a slots=1\nnode-b slots=1\n", "local")])
def test_runner_launches_a_script_with_the_rendezvous_env(tmp_path, hosts, launcher):
    hostfile, script = tmp_path / "hostfile", tmp_path / "show_env.py"
    hostfile.write_text(hosts)
    script.write_text(_PRINT_ENV.format(out=str(tmp_path)))
    proc = subprocess.run([sys.executable, "-m", "deepspeed_tpu_torch.launcher.runner", "--hostfile",
                           str(hostfile), "--launcher", launcher, "--master_port", "29517", str(script)],
                          cwd=REPO, env=_env(), capture_output=True, text=True, timeout=60)
    assert proc.returncode == 0, proc.stderr
    n = len(hosts.splitlines())
    active = trunner.parse_resource_filter(trunner.fetch_hostfile(str(hostfile)))
    master = "127.0.0.1" if n == 1 else "node-a"
    for rank in range(n):
        env = json.loads((tmp_path / f"env-{rank}.json").read_text())
        assert env == {"RANK": str(rank), "WORLD_SIZE": str(n), "LOCAL_RANK": "0", "MASTER_ADDR": master,
                       "MASTER_PORT": "29517", "DSTPU_COORDINATOR": f"{master}:29517",
                       "DSTPU_NUM_PROCESSES": str(n), "DSTPU_PROCESS_ID": str(rank),
                       "DSTPU_WORLD_INFO": trunner.encode_world_info(active)}
        assert trunner.decode_world_info(env["DSTPU_WORLD_INFO"]) == dict(active)


_TREE = """
import os, subprocess, sys, time
child = subprocess.Popen([sys.executable, "-c", "import time; time.sleep(120)"])
with open({pids!r} + ".tmp", "w") as f:
    f.write(f"{{os.getpid()}} {{child.pid}}")
os.replace({pids!r} + ".tmp", {pids!r})
time.sleep(120)
"""


def _gone(pid):
    try:
        with open(f"/proc/{pid}/stat") as f:
            return f.read().split(")")[-1].split()[0] in ("Z", "X")  # a zombie runs nothing
    except FileNotFoundError:
        return True


def test_sigterm_to_launch_ends_the_child_tree(tmp_path):
    pids, script = str(tmp_path / "pids"), tmp_path / "tree.py"
    script.write_text(_TREE.format(pids=pids))
    proc = subprocess.Popen([sys.executable, "-m", "deepspeed_tpu_torch.launcher.launch", "--node_rank", "0",
                             "--num_nodes", "1", "--coordinator", "127.0.0.1:29518", str(script)],
                            cwd=REPO, env=_env(), stdout=subprocess.PIPE, stderr=subprocess.PIPE)
    try:
        deadline = time.monotonic() + 60
        while not os.path.exists(pids):
            assert time.monotonic() < deadline and proc.poll() is None, "the child never started"
            time.sleep(0.1)
        tree = [int(p) for p in open(pids).read().split()]
        assert not any(_gone(p) for p in tree)
        proc.send_signal(signal.SIGTERM)
        rc = proc.wait(timeout=30)
        deadline = time.monotonic() + 10
        while not all(_gone(p) for p in tree):
            assert time.monotonic() < deadline, f"the tree outlived its launcher: {tree}"
            time.sleep(0.1)
        assert rc == (-signal.SIGTERM) % 256  # launch returns the child's -15
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
