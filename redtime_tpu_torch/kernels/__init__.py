"""Hand-written Hopper kernels, each beside its plain PyTorch version:

  * `out_leg`   — K1, CUDA C++ (csrc/out_leg.cu): the engine's per-family
                  output leg, J = (tab_a * tab_b / 2np) @ G;
  * `pz_leg`    — K2, CUDA C++ (csrc/pz_leg.cu): the Z-kernel Toeplitz
                  contraction with its outer-factor epilogue;
  * `rk_finish` — K3, CUDA C++ (csrc/rk_attempt.cu): `rk_stage`, one
                  stage input of an RK attempt, and `rk_finish`, the
                  attempt's tail with the GSL step controller;
  * `rhs_tail`  — K8, CUDA C++ (csrc/rhs_tail.cu): the Time-RG RHS after
                  the engine (Omega, the A/R assembly or the 1-loop
                  rescale, dlnP / dI / dQ);
  * `out_block` — K11, CUDA C++ (csrc/out_block.cu): the output block,
                  every output redshift's columns, sigma_v^2 and H;
  * `probes`    — K4 `affine`, K5 `int8_dot`, K6 `dd_mul`, CUDA C++
                  (csrc/probes.cu): the Pallas feasibility probes P1-P3.

A wrapper takes the plain version only for tensors on the CPU; for CUDA
tensors it launches its kernel or raises.  Each module holds its wrapper
and plain version under the module's own name (out_leg.out_leg,
out_leg.out_leg_plain, ...); `counts` holds the launch counters and
`build` compiles the CUDA sources.
"""
