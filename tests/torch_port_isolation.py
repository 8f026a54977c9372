"""Process-wide state of the port's test modules, kept inside each module.

Under ``pytest -n N --dist loadfile`` one worker process imports every
test module at collection and then runs whole files one after another, in
an order that varies from run to run. So a test module changes nothing
process-wide at import but the fixed baseline below, and what it changes
while it runs it gives back:

* importing this module sets the process's baseline to one intra-op
  thread, the same in every worker whatever the order (each worker
  imports every test module at collection): the JAX package's
  ``tests/test_grad_parity_torch.py`` holds a stem gradient that matches
  at one thread only (alone, at torch's default of one thread a core, it
  fails) and sets no count itself;
* ``isolated(threads)`` is an autouse module fixture: torch's intra-op
  thread count pinned for the module's tests and restored after them; the
  launcher's variables (``WORLD_SIZE``, ``MASTER_ADDR``, ...) snapshotted
  and put back; a process group found at either end torn down, so that a
  module never sees one another module left behind;
* ``subprocess_env(**extra)`` is ``os.environ`` without the launcher's
  variables, for the entry points a test runs as a subprocess;
* ``removed_after(path)`` deletes a module's large outputs once its tests
  are done, and the ``scratch_path`` fixture is a ``tmp_path`` deleted
  after its test: pytest keeps the temporary directories of its last three
  runs, so what a run leaves behind adds up on the disk (a whole run of
  the repo's tests wrote 6 GB).
"""

import contextlib
import os
import shutil

import pytest
import torch
import torch.distributed as dist

torch.set_num_threads(1)  # the baseline (module docstring)

LAUNCHER_VARS = ("WORLD_SIZE", "RANK", "LOCAL_RANK", "LOCAL_WORLD_SIZE",
                 "GROUP_RANK", "ROLE_RANK", "MASTER_ADDR", "MASTER_PORT",
                 "TORCHELASTIC_RUN_ID")


def _drop_group() -> None:
    if dist.is_available() and dist.is_initialized():
        from protoasnet_tpu_torch.parallel.mesh import shutdown_distributed

        shutdown_distributed()


def isolated(threads: int):
    """An autouse module fixture: ``threads`` intra-op threads for the
    module, the launcher's variables and the process group as they were
    (none) around it."""

    @pytest.fixture(scope="module", autouse=True)
    def _isolated():
        saved_threads = torch.get_num_threads()
        saved_env = {k: os.environ.get(k) for k in LAUNCHER_VARS}
        _drop_group()
        torch.set_num_threads(threads)
        try:
            yield
        finally:
            torch.set_num_threads(saved_threads)
            for k, v in saved_env.items():
                if v is None:
                    os.environ.pop(k, None)
                else:
                    os.environ[k] = v
            _drop_group()

    return _isolated


def subprocess_env(**extra: str) -> dict:
    """``os.environ`` without the launcher's variables, plus ``extra``."""
    env = {k: v for k, v in os.environ.items() if k not in LAUNCHER_VARS}
    env.update(extra)
    return env


@contextlib.contextmanager
def removed_after(path):
    """``path`` while the block runs; deleted (with what it holds) after."""
    try:
        yield path
    finally:
        shutil.rmtree(path, ignore_errors=True)


@pytest.fixture
def scratch_path(tmp_path):
    """``tmp_path``, deleted after the test (agent runs, checkpoints)."""
    with removed_after(tmp_path):
        yield tmp_path
