"""hygeia_tpu: a JAX/XLA framework for DNA-methylation change-point
segmentation and differential methylation analysis, run on NVIDIA GPUs.

Re-designed from scratch with the capabilities of ucl-medical-genomics/hygeia
(reference: Nextflow + C++/R single-group SMC engine + TF/TFP two-group
particle filter), built for accelerators:

- All inference hot loops are ``lax.scan`` bodies compiled by XLA.
- Particle sets use static shapes with -inf-masked log-weights.
- Seeds/segments parallelise via ``vmap`` / ``shard_map`` over a device mesh.
- File I/O only at pipeline edges; everything in between stays on device.

Subpackages
-----------
ops           Numerics core: distributions, hazard tables, resampling.
single_group  Online SMC engine: joint regime smoothing + parameter estimation.
two_group     Case/control (merged/split) deterministic-proposal particle
              filter with backward simulation.
pipeline      Preprocessing, segmentation, aggregation, DMP calling, BED export.
parallel      Device-mesh sharding utilities (genome-block x seed parallelism).
"""

__version__ = "0.1.0"
