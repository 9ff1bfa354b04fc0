"""SIGTERM mid-training in the port: the trainer stops at the next step
boundary, writes its checkpoint, logs the signal, restores the previous
handlers and exits 0; the run resumes from that checkpoint (the port of
``tests/test_preemption.py`` to ``zigma_tpu_torch.cli.train ...
device=cpu``).  Then the same under two gloo processes: both ranks stop at
the same step, rank 0 writes one checkpoint, both exit 0."""

import os
import signal
import subprocess
import sys
import textwrap
import time

import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

WORKER = textwrap.dedent("""
    import os, signal, sys
    sys.path.insert(0, {repo!r})
    import torch
    torch.set_num_threads(1)
    before = signal.getsignal(signal.SIGTERM)
    if len(sys.argv) > 3:  # rank, world: a gloo group of the processes
        import torch.distributed as dist
        dist.init_process_group(
            "gloo", init_method="file://" + sys.argv[1] + "/store",
            rank=int(sys.argv[2]), world_size=int(sys.argv[3]))
    from zigma_tpu_torch.cli.train import main
    res = main(["model=zigzag8_b1_pe2", "data=synthetic", "data.batch_size=2",
                "data.train_steps=100000", "model.params.embed_dim=32",
                "model.params.depth=2", "model.params.img_dim=8",
                "log_every=5", "device=cpu",
                "results_dir=" + sys.argv[1] + "/results"])
    assert signal.getsignal(signal.SIGTERM) is before
    print("STOPPED", res["signal"], res["state"].step, res["checkpoint"],
          flush=True)
""")


def _start(tmp_path, *args):
    script = tmp_path / "worker.py"
    script.write_text(WORKER.format(repo=REPO))
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["OMP_NUM_THREADS"] = "1"
    if len(args) > 1:
        env["ZIGMA_DISTRIBUTED"] = "1"
    return subprocess.Popen([sys.executable, str(script), str(tmp_path),
                             *map(str, args)], stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True, env=env)


def _wait_for_steps(proc):
    """Read until the first ``steps/sec`` line; returns the lines read."""
    deadline, lines = time.time() + 300, []
    while time.time() < deadline:
        line = proc.stdout.readline()
        if not line:  # EOF: the child died before reaching the loop
            break
        lines.append(line)
        if "steps/sec" in line:
            return lines
    proc.kill()
    raise AssertionError("worker never reached the train loop:\n"
                         + "".join(lines))


def _stopped(out):
    (line,) = [ln for ln in out.splitlines() if ln.startswith("STOPPED")]
    _, sig, step, path = line.split()
    return int(sig), int(step), path


def test_sigterm_checkpoints_and_resumes(tmp_path):
    proc = _start(tmp_path)
    _wait_for_steps(proc)
    proc.send_signal(signal.SIGTERM)
    rest, _ = proc.communicate(timeout=300)
    assert proc.returncode == 0, rest
    assert "checkpointing and exiting at step" in rest
    sig, step, path = _stopped(rest)
    assert sig == signal.SIGTERM and step >= 5
    assert os.path.basename(path) == f"{step:07d}.pt"
    ck = torch.load(path, weights_only=False)
    assert ck["train_steps"] == step
    # the run resumes from it (and is stopped again, past it)
    proc = _start(tmp_path)
    lines = _wait_for_steps(proc)
    assert any(f"resuming from {path}" in ln for ln in lines)
    proc.send_signal(signal.SIGINT)
    rest, _ = proc.communicate(timeout=300)
    assert proc.returncode == 0, rest
    sig2, step2, _ = _stopped(rest)
    assert sig2 == signal.SIGINT and step2 > step


def test_sigterm_stops_every_rank_at_one_step(tmp_path):
    """Only rank 1 is signalled; both stop at the same step boundary, over
    the CPU group the trainer keeps for it, and checkpoint together."""
    procs = [_start(tmp_path, r, 2) for r in range(2)]
    _wait_for_steps(procs[0])
    procs[1].send_signal(signal.SIGTERM)
    outs = [p.communicate(timeout=300)[0] for p in procs]
    for p, out in zip(procs, outs):
        assert p.returncode == 0, out[-4000:]
    (s0, step0, path0), (s1, step1, path1) = map(_stopped, outs)
    assert s0 == s1 == signal.SIGTERM and step0 == step1 >= 5
    assert path0 == path1 and os.path.exists(path0)
    ck = torch.load(path0, weights_only=False)
    assert ck["train_steps"] == step0
    assert not any(k.startswith("module.") for k in ck["model"])
