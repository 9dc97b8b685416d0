"""The distributed unittest base (port of
``apex_tpu/transformer/testing/distributed_test_base.py``, after Apex's
``apex/transformer/testing/distributed_test_base.py``).

Each test runs with the ``parallel_state`` grid of the class's
``TP``/``PP``/``CP`` bound over the ``torch.distributed`` world it finds
(every rank of a launched world runs the test), or, with none started,
over a world of one rank of its own (``BACKEND`` over a file store,
ended after the test). A test skips when the world's size is not a
multiple of ``TP * PP * CP``.
"""

from __future__ import annotations

import shutil
import tempfile
import unittest

import torch

from apex_tpu_torch.distributed import backend as _backend
from apex_tpu_torch.transformer import parallel_state
from apex_tpu_torch.transformer.testing import global_vars


class DistributedTestBase(unittest.TestCase):
    """``distributed_test_base.py:DistributedTestBase`` over gloo groups;
    ``self.mesh`` is the bound grid."""

    TP = 1
    PP = 1
    CP = 1
    BACKEND = "gloo"

    @property
    def world_size(self) -> int:
        return _backend.get_world_size() if _backend.is_initialized() else 1

    def _start_own_world(self):
        self._own_dir = None
        if not _backend.is_initialized():
            self._own_dir = tempfile.mkdtemp(prefix="apex_tpu_torch_dist_")
            _backend.init_process_group(
                self.BACKEND, init_method=f"file://{self._own_dir}/store",
                world_size=1, rank=0)

    def _end_own_world(self):
        if self._own_dir is not None:
            _backend.destroy_process_group()
            shutil.rmtree(self._own_dir, ignore_errors=True)
            self._own_dir = None

    def setUp(self):
        super().setUp()
        self._start_own_world()
        need = self.TP * self.PP * self.CP
        if self.world_size % need:
            self._end_own_world()
            self.skipTest(f"needs a multiple of {need} ranks, have "
                          f"{self.world_size}")
        parallel_state.destroy_model_parallel()
        self.mesh = parallel_state.initialize_model_parallel(
            self.TP, self.PP, context_parallel_size_=self.CP)

    def tearDown(self):
        parallel_state.destroy_model_parallel()
        global_vars.destroy_global_vars()
        self._end_own_world()
        super().tearDown()


class NcclDistributedTestBase(DistributedTestBase):
    """The base over NCCL groups: skips without a GPU."""

    BACKEND = "nccl"

    def setUp(self):
        if not torch.cuda.is_available():
            self.skipTest("NCCL needs a GPU")
        super().setUp()
