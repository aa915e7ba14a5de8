"""A frozen copy of the plain path of redtime_tpu_torch: the benchmark's
reference.

The modules are the port's, with three changes: imports name this
package; every kernel wrapper takes its plain PyTorch version on every
device (`kernels.build` launches nothing); and the float dtype is each
module's `F64`, which `precision.use` sets (float64 unless a control
asks for less).  It imports nothing of redtime_tpu_torch and no JAX.
"""
