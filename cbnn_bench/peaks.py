"""Published peaks of one NVIDIA H100 SXM5 80 GB (NVIDIA's data sheet,
dense rates, at the full 700 W power limit): 1,979 TOP/s on the int8
tensor cores, 3.35 TB/s of HBM3."""

INT8_OPS = 1.979e15
HBM_BPS = 3.35e12
