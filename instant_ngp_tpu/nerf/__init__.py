"""NeRF workload: occupancy grid, sampling, composite loss, rendering.

JAX re-design of the reference NeRF testbed
(src/testbed_nerf.cu, 3282 LoC). See SURVEY.md §2.2 for the semantics map.
"""
