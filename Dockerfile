# Container packaging for drop-in pipeline use — the analog of the
# reference's two per-engine images (src/two_group/Dockerfile,
# src/single_group/Dockerfile; pulled by every Nextflow module). One image
# serves both engines here because both are the same JAX package.
#
# CPU image by default. For NVIDIA GPU hosts, swap "jax>=0.9" for
# "jax[cuda12]>=0.9" and run with --gpus all. pandas is only needed by the
# BED/gemBS preprocess verbs and BED export.

FROM python:3.12-slim

WORKDIR /opt/hygeia_tpu

COPY pyproject.toml README.md ./
COPY hygeia_tpu ./hygeia_tpu

RUN pip install --no-cache-dir "jax>=0.9" numpy pandas scipy optax \
    && pip install --no-cache-dir --no-deps .

# Verb-compatible entrypoint: `docker run <img> infer --help` etc., matching
# the reference's bin/hygeia dispatcher surface.
ENTRYPOINT ["python", "-m", "hygeia_tpu.cli"]
