# fabstir-vectordb-tpu REST server image.
# Deployment parity with the reference's Dockerfile/Dockerfile.production.
# JAX comes as its CUDA 12 wheel (the CUDA libraries are pip packages);
# run with the NVIDIA container toolkit (`docker run --gpus 1 ...`). Pass
# --build-arg JAX_SPEC="jax[cpu]" for a CPU-only image.

# --- wasm build stage: the full embedded runtime for browsers ------------
# Compiles fvdb_embedded.{js,wasm} from the same C++ sources as the native
# runtime (bindings/wasm/build.sh). The hand-assembled fvdb_kernels.wasm is
# already committed in-tree (generated + interpreter-validated in CI, see
# bindings/wasm/gen_kernels.py); this stage adds the emscripten artifact
# that the Python build image cannot produce (no emcc there).
FROM emscripten/emsdk:3.1.61 AS wasm
WORKDIR /src
COPY fabstir_vectordb_tpu/native ./fabstir_vectordb_tpu/native
COPY bindings/wasm ./bindings/wasm
RUN cd bindings/wasm && ./build.sh

FROM python:3.12-slim

RUN apt-get update && apt-get install -y --no-install-recommends g++ \
    && rm -rf /var/lib/apt/lists/*

ARG JAX_SPEC="jax[cuda12]"

WORKDIR /app
COPY pyproject.toml README.md ./
COPY fabstir_vectordb_tpu ./fabstir_vectordb_tpu

RUN pip install --no-cache-dir "${JAX_SPEC}" numpy aiohttp requests \
        zstandard cryptography \
    && pip install --no-cache-dir -e .

# Pre-build the native runtime library.
RUN python -c "from fabstir_vectordb_tpu.native import load_library; load_library()"

# Browser artifacts (served under /static for embedding clients).
COPY bindings/wasm/fvdb_kernels.wasm bindings/wasm/kernels.mjs \
     bindings/wasm/index.mjs ./static/wasm/
COPY --from=wasm /src/bindings/wasm/fvdb_embedded.js \
     /src/bindings/wasm/fvdb_embedded.wasm ./static/wasm/

ENV VECTOR_DB_HOST=0.0.0.0 \
    VECTOR_DB_PORT=7533 \
    STORAGE_MODE=fs \
    FS_STORAGE_ROOT=/data

VOLUME /data
EXPOSE 7533

CMD ["python", "-m", "fabstir_vectordb_tpu.api.server"]
