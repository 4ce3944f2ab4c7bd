"""``m2l_ms_per_step``: device ms a step in the FMM's M2L convolutions
(``fmm._m2l_level_conv``: one ``conv3d``, or ``conv2d`` in 2-D, a level,
in full float32 under ``fmm._no_tf32``). The program runs no other
convolution, so every kernel that cuDNN launches for one is M2L's,
matched by name (``M2L_KERNELS``): on an H100 with torch 2.11 the 3-D
million-body grids run ``sm80_xmma_fprop_implicit_gemm_indexed_f32f32_
f32f32_f32_nchwkcrs_nchw_...`` (an implicit-GEMM forward convolution in
FP32 FMAs), one a level; other engines cuDNN may pick name themselves
``implicit_convolve...``, ``...fprop...`` or a layout transform around
one. The folding of the weights around the call (elementwise kernels) is
left to ``other_device_ms_per_step``. Steps are the traced job's executed
steps (``trace.executed_steps``). None where no such kernel ran. Layer:
step tail and bh structure in plain torch."""

import re

from perfbench.trace import executed_steps

M2L_KERNELS = re.compile(
    r"fprop|implicit_gemm|implicit_convolve|conv[23]d|nchwToNhwc|nhwcToNchw",
    re.IGNORECASE)


def read(record):
    tr = record["trace"]
    if not tr:
        return None
    ns = sum(e - s for name, s, e in tr["device"] if M2L_KERNELS.search(name))
    if not ns:
        return None
    return ns / 1e6 / executed_steps(record)
