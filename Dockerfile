# memo-tpu container (the reference ships a Dockerfile building MONI +
# samtools + seqtk, reference Dockerfile:1-39; this image needs neither —
# the matching-statistics engine is in-repo C++ compiled on first use).
#
# The query path runs on an NVIDIA GPU: the CUDA build of jax brings its
# own CUDA libraries as wheels, so a plain Python base and the host's NVIDIA
# driver (docker run --gpus all) suffice. Without a GPU the same image runs
# on the CPU backend.
FROM python:3.12-slim

RUN apt-get update && apt-get install -y --no-install-recommends g++ && \
    rm -rf /var/lib/apt/lists/*

WORKDIR /memo-tpu
COPY pyproject.toml README.md ./
COPY memo_tpu ./memo_tpu
RUN pip install --no-cache-dir "jax[cuda12]" "numpy" "pyarrow" "matplotlib" && \
    pip install --no-cache-dir -e .

ENTRYPOINT ["memo-tpu"]
CMD ["--help"]
