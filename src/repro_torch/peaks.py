"""The peaks of one NVIDIA H100 (NVIDIA's data sheet, SXM part, dense
rates at the 700 W limit): the one source every bound of this package
and of ``chip_smoke.py`` reads.

  bf16 tensor cores   989 TFLOP/s     (``BF16_OPS``)
  int8 tensor cores   1,979 TOP/s     (``INT8_OPS``)
  float32 CUDA cores  67 TFLOP/s      (``FP32_OPS``)
  HBM                 3.35 TB/s       (``HBM_BPS``)

It imports nothing: the secure cost model (``core.cost_model``) and the
LM roofline (``roofline.analyze``) both read it.
"""
__all__ = ["BF16_OPS", "INT8_OPS", "FP32_OPS", "HBM_BPS"]

BF16_OPS = 989e12
INT8_OPS = 1.979e15
FP32_OPS = 67e12
HBM_BPS = 3.35e12
