"""Real multi-process distributed bring-up on localhost CPU.

Everything else in tests/ runs single-process on a virtual 8-device mesh,
which never executes the jax.distributed.initialize wiring or the
process-local-data branch of the psum health check
(parallel/distributed.py). These tests spawn two ACTUAL processes joined
through a Gloo coordinator and drive:

  1. init_distributed() -> _psum_health_check()'s
     jax.make_array_from_process_local_data branch (process_count() == 2),
  2. a tp=2 shard_map forward where each process owns one device of the
     mesh, asserting both ranks compute identical finite logits.

The reference has no distributed story (SURVEY.md §5); this is the
north-star 2-host serving path scaled down to 2 localhost processes.
Marked slow: each worker pays a full fresh-interpreter JAX import.
"""

import os
import socket
import subprocess
import sys
import textwrap

import pytest

pytestmark = pytest.mark.slow

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

WORKER = textwrap.dedent("""
    import sys
    port, pid, model_path = sys.argv[1], int(sys.argv[2]), sys.argv[3]
    import jax
    jax.config.update("jax_platforms", "cpu")
    sys.path.insert(0, {repo!r})
    from gguf_tpu.parallel.distributed import init_distributed

    info = init_distributed(coordinator_address=f"localhost:{{port}}",
                            num_processes=2, process_id=pid)
    assert info["num_processes"] == 2, info
    assert info["global_devices"] == 2, info
    assert info.get("psum_ok") is True, info
    print(f"PSUM_OK rank={{pid}}", flush=True)

    import numpy as np
    import jax.numpy as jnp
    from gguf_tpu.models import LlamaConfig
    from gguf_tpu.models.loader import write_random_llama_gguf, load_llama
    from gguf_tpu.parallel.tp import (make_mesh, shard_llama, make_tp_forward,
                                      init_sharded_cache)

    cfg0 = LlamaConfig(vocab_size=256, dim=512, n_layers=1, n_heads=4,
                       n_kv_heads=2, ffn_dim=512, max_seq_len=32)
    if pid == 0:   # one writer; rank 1 waits for the atomic rename
        write_random_llama_gguf(model_path + ".tmp", cfg0, seed=3)
        import os as _os; _os.replace(model_path + ".tmp", model_path)
    else:
        import os as _os, time as _time
        deadline = _time.time() + 60
        while not _os.path.exists(model_path):
            assert _time.time() < deadline, "rank 0 never wrote the model"
            _time.sleep(0.2)
    cfg, params = load_llama(model_path)

    mesh = make_mesh(tp=2)           # 2 global devices, 1 per process
    params_s, cfg_s = shard_llama(params, cfg, mesh)
    fwd = make_tp_forward(cfg_s, mesh)
    cache = init_sharded_cache(cfg_s, mesh, batch=2, max_seq=32)
    toks = jnp.asarray(np.full((2, 2), 7, np.int32))
    logits, cache = fwd(params_s, toks, jnp.zeros(2, jnp.int32), cache)
    lg = np.asarray(jax.device_get(logits[:, -1, :8]))
    assert np.isfinite(lg).all(), lg
    print(f"TP_FWD_OK rank={{pid}} " + " ".join(f"{{v:.6f}}" for v in lg[0]),
          flush=True)
""")


def _free_port() -> int:
    s = socket.socket()
    s.bind(("localhost", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _run_ranks(tmp_path, worker_src, n_ranks=2, timeout=600, env_extra=None,
               check=True):
    """Spawn n_ranks workers of worker_src (formatted with repo=REPO) joined
    on a fresh coordinator port; returns (procs' outputs, return codes)."""
    script = tmp_path / "worker.py"
    script.write_text(worker_src.format(repo=REPO))
    port = _free_port()
    env = dict(os.environ)
    env.pop("XLA_FLAGS", None)
    if env_extra:
        env.update(env_extra)
    procs = [
        subprocess.Popen(
            [sys.executable, str(script), str(port), str(rank)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
            env=env, cwd=str(tmp_path))
        for rank in range(n_ranks)
    ]
    outs, codes = [], []
    for p in procs:
        try:
            out, _ = p.communicate(timeout=timeout)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            raise
        outs.append(out)
        codes.append(p.returncode)
        if check:
            assert p.returncode == 0, f"rank failed:\n{out}"
    return outs, codes


def test_two_process_tp2_forward(tmp_path):
    """Spawn 2 ranks; assert health check + identical cross-rank logits."""
    script = tmp_path / "worker.py"
    script.write_text(WORKER.format(repo=REPO))
    model_path = str(tmp_path / "model.gguf")
    port = _free_port()

    env = dict(os.environ)
    env.pop("XLA_FLAGS", None)   # one real device per process, not 8 virtual
    procs = [
        subprocess.Popen(
            [sys.executable, str(script), str(port), str(rank), model_path],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
            env=env, cwd=str(tmp_path))
        for rank in (0, 1)
    ]
    outs = []
    for p in procs:
        try:
            out, _ = p.communicate(timeout=600)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            raise
        outs.append(out)
        assert p.returncode == 0, f"rank failed:\n{out}"

    logits = {}
    for rank, out in enumerate(outs):
        assert f"PSUM_OK rank={rank}" in out, out
        for line in out.splitlines():
            if line.startswith(f"TP_FWD_OK rank={rank}"):
                logits[rank] = line.split(None, 2)[2]
    assert set(logits) == {0, 1}, outs
    # the logits all-gather must leave every rank with the same values
    assert logits[0] == logits[1], logits


# ---------------------------------------------------------------------------
# Failure-path coverage: multi-host serving leans on this bootstrap and
# nothing else in the environment can exercise it.
# ---------------------------------------------------------------------------

PEER_MISSING = textwrap.dedent("""
    import sys
    port, pid = sys.argv[1], int(sys.argv[2])
    import jax
    jax.config.update("jax_platforms", "cpu")
    sys.path.insert(0, {repo!r})
    from gguf_tpu.parallel.distributed import init_distributed

    # claim 2 processes but only rank 0 ever starts: bring-up must FAIL
    # within the timeout, not hang at the first collective. The JAX
    # distributed client LOG(FATAL)s on RegisterTask DEADLINE_EXCEEDED
    # (it does NOT raise a Python exception), so detection = nonzero exit
    # + the deadline message — what a supervisor actually observes.
    init_distributed(coordinator_address=f"localhost:{{port}}",
                     num_processes=2, process_id=0,
                     initialization_timeout=15)
    print("UNEXPECTED_SUCCESS", flush=True)
""")


def test_peer_missing_times_out(tmp_path):
    """A dead host at bring-up is a bounded, loud failure (fatal exit within
    the initialization_timeout), not an indefinite hang."""
    outs, codes = _run_ranks(tmp_path, PEER_MISSING, n_ranks=1, timeout=180,
                             check=False)
    assert codes[0] != 0, outs[0]
    assert "UNEXPECTED_SUCCESS" not in outs[0], outs[0]
    assert "DEADLINE_EXCEEDED" in outs[0] or "Deadline Exceeded" in outs[0], \
        outs[0]


MESH_MISMATCH = textwrap.dedent("""
    import sys
    port, pid = sys.argv[1], int(sys.argv[2])
    import jax
    jax.config.update("jax_platforms", "cpu")
    sys.path.insert(0, {repo!r})
    from gguf_tpu.parallel.distributed import init_distributed
    from gguf_tpu.parallel.tp import make_mesh

    info = init_distributed(coordinator_address=f"localhost:{{port}}",
                            num_processes=2, process_id=pid)
    assert info["psum_ok"] is True, info
    # the slice has 2 global devices; tp=4 must be rejected loudly at mesh
    # construction, BEFORE any weight is sharded
    try:
        make_mesh(tp=4)
    except AssertionError:
        print(f"MESH_MISMATCH_REJECTED rank={{pid}}", flush=True)
    else:
        print("UNEXPECTED_MESH_OK", flush=True)
        sys.exit(1)
    # and the correctly-sized mesh still works after the failed attempt
    mesh = make_mesh(tp=2)
    assert mesh.devices.size == 2
    print(f"MESH_OK rank={{pid}}", flush=True)
""")


def test_mesh_mismatch_rejected(tmp_path):
    outs, _ = _run_ranks(tmp_path, MESH_MISMATCH)
    for rank, out in enumerate(outs):
        assert f"MESH_MISMATCH_REJECTED rank={rank}" in out, out
        assert f"MESH_OK rank={rank}" in out, out


MID_RUN_ABORT = textwrap.dedent("""
    import os, sys, threading, time
    port, pid = sys.argv[1], int(sys.argv[2])
    import jax
    jax.config.update("jax_platforms", "cpu")
    sys.path.insert(0, {repo!r})
    from gguf_tpu.parallel.distributed import init_distributed, \\
        _psum_health_check

    info = init_distributed(coordinator_address=f"localhost:{{port}}",
                            num_processes=2, process_id=pid)
    assert info["psum_ok"] is True, info
    print(f"INIT_OK rank={{pid}}", flush=True)
    if pid == 1:
        os._exit(0)   # simulated mid-run host death, after healthy bring-up

    # rank 0: a post-mortem collective must NOT succeed. Accept either an
    # exception or a hang (watchdog converts the hang into exit code 3) —
    # the failure mode a health-checking supervisor must handle.
    def watchdog():
        time.sleep(60)
        print("ABORT_HUNG", flush=True)
        os._exit(3)
    threading.Thread(target=watchdog, daemon=True).start()
    time.sleep(2.0)   # let rank 1's death propagate
    try:
        ok = _psum_health_check()
    except Exception as e:
        print(f"ABORT_DETECTED {{type(e).__name__}}", flush=True)
        os._exit(0)
    if ok:
        print("UNEXPECTED_PSUM_OK", flush=True)
        os._exit(1)
    print("ABORT_DETECTED bad_sum", flush=True)
    os._exit(0)
""")


def test_mid_run_abort_detected(tmp_path):
    """After a peer dies mid-run, a collective on the survivor must not
    silently return success."""
    outs, codes = _run_ranks(tmp_path, MID_RUN_ABORT, timeout=300,
                             check=False)
    assert codes[1] == 0, outs[1]
    assert "INIT_OK rank=0" in outs[0], outs[0]
    assert "UNEXPECTED_PSUM_OK" not in outs[0], outs[0]
    assert codes[0] in (0, 3), (codes, outs[0])
    assert ("ABORT_DETECTED" in outs[0]) or ("ABORT_HUNG" in outs[0]), \
        outs[0]


TWO_BY_FOUR = textwrap.dedent("""
    import sys
    port, pid = sys.argv[1], int(sys.argv[2])
    import os
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    import jax
    jax.config.update("jax_platforms", "cpu")
    sys.path.insert(0, {repo!r})
    import numpy as np
    import jax.numpy as jnp
    from jax.sharding import PartitionSpec as P
    from gguf_tpu.parallel.distributed import init_distributed
    from gguf_tpu.parallel.tp import make_mesh

    info = init_distributed(coordinator_address=f"localhost:{{port}}",
                            num_processes=2, process_id=pid)
    assert info["num_processes"] == 2, info
    assert info["local_devices"] == 4, info
    assert info["global_devices"] == 8, info
    assert info["psum_ok"] is True, info
    print(f"PSUM8_OK rank={{pid}}", flush=True)

    # dp spans the process (host) boundary, tp the 4 process-local devices —
    # the axis split of a 2-host deployment
    mesh = make_mesh(tp=4, dp=2)
    x = jax.make_array_from_process_local_data(
        jax.NamedSharding(mesh, P(("dp",), ("tp",))),
        np.full((1, 4), pid + 1, np.float32), (2, 4))

    def f(x):
        tp_sum = jax.lax.psum(x, "tp")       # within-process collective
        dp_sum = jax.lax.psum(tp_sum, "dp")  # cross-process collective
        return dp_sum

    got = jax.jit(jax.shard_map(
        f, mesh=mesh, in_specs=P(("dp",), ("tp",)), out_specs=P()))(x)
    v = float(np.asarray(jax.device_get(got))[0, 0])
    assert v == (1 + 2) * 4, v   # sum over dp ranks of 4*rank_value
    print(f"TP4DP2_OK rank={{pid}} {{v}}", flush=True)
""")


def test_two_process_four_virtual_devices(tmp_path):
    """Multi-process bootstrap composed with a 4-wide process-local mesh
    axis: the dp(x-host) x tp(local) split of a 2-host deployment."""
    outs, _ = _run_ranks(tmp_path, TWO_BY_FOUR)
    for rank, out in enumerate(outs):
        assert f"PSUM8_OK rank={rank}" in out, out
        assert f"TP4DP2_OK rank={rank}" in out, out
