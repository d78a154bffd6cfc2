"""mpc_tpu — batched NMPC trajectory-optimization framework.

A from-scratch JAX/XLA/Pallas re-design of the capabilities of the reference
CommonRoad MPC motion planner (CasADi/IPOPT + FORCESPRO SQP), built for
batched execution on accelerators; it runs on NVIDIA GPUs.
"""
__version__ = "0.1.0"
