"""Inputs shared by the port's tests and ``chip_smoke.py``.  Imports
nothing of JAX, so the card-side checks can use it where JAX is absent."""


def wide_routes(k):
    """A static route table whose destinations reach k - 1, with a pin, an
    exclude list and two hashed terms."""
    return (
        (k - 40_000, ((0, 0x9E3779B9, 20_000, 2),), (0, 1), (), ((1, (3, 4)),)),
        (5, ((1, 12_345, 7, 1), (0, 999, 3, 7)), (0,), ((0, 7),), ()),
        (k - 1, (), (0,), (), ()),
    )


def gloo_ranks_and_jax(port_code: str, jax_code: str, world: int) -> tuple[list, dict]:
    """Run ``port_code`` as ``world`` Python processes, each given its rank,
    the world size and a file store's path as arguments (to join a gloo
    group), beside ``jax_code`` in a process of its own; each prints one
    ``RESULT <json>`` line.  Returns (each rank's result, JAX's).  Every
    process is killed on the way out; each gets 240 s."""
    import json
    import subprocess
    import sys
    import tempfile
    from pathlib import Path

    root = Path(__file__).resolve().parents[1]
    popen = dict(stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, cwd=root,
                 env={"PYTHONPATH": str(root / "src"), "PATH": "/usr/bin:/bin:/usr/local/bin"})

    def result(proc):
        out, err = proc.communicate(timeout=240)
        assert proc.returncode == 0, err[-3000:]
        line = [ln for ln in out.splitlines() if ln.startswith("RESULT ")]
        assert line, out[-2000:]
        return json.loads(line[0][len("RESULT "):])

    with tempfile.TemporaryDirectory() as tmp:
        jax_proc = subprocess.Popen([sys.executable, "-c", jax_code], **popen)
        ranks = [subprocess.Popen([sys.executable, "-c", port_code, str(rank), str(world),
                                   str(Path(tmp) / "store")], **popen) for rank in range(world)]
        try:
            return [result(p) for p in ranks], result(jax_proc)
        finally:
            for p in ranks + [jax_proc]:
                p.kill()
                p.wait(timeout=30)
