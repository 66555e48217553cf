#!/usr/bin/env bash
# Browser/WASM build of the embedded index runtime.
#
# Compiles the same C++ sources the native ctypes runtime uses
# (fabstir_vectordb_tpu/native/src/fvdb_native.cpp — InMemoryIndex,
# SearchFilter-compatible scans, vector math, cosine k-means) to
# fvdb_embedded.{js,wasm} with emscripten. The JS wrapper (index.mjs)
# exposes the reference WASM crate's API (InMemoryIndex, Vector/VectorBatch,
# video helpers) over the exported C ABI.
#
# Requires emscripten (emcc) on PATH; the repository's Python build image
# does not ship it, so this artifact is produced by downstream packaging
# (see the `wasm` stage in /Dockerfile). A toolchain-free companion,
# fvdb_kernels.wasm (hand-assembled hot kernels, generated by
# ./gen_kernels.py and interpreter-validated in CI), IS committed in-tree
# and loads via ./kernels.mjs with zero emscripten involvement.
set -euo pipefail
cd "$(dirname "$0")"

if ! command -v emcc >/dev/null 2>&1; then
  echo "emcc not found — install emscripten (https://emscripten.org) first" >&2
  exit 1
fi

SRC=../../fabstir_vectordb_tpu/native/src/fvdb_native.cpp

emcc -O3 -std=c++17 "$SRC" \
  -s MODULARIZE=1 -s EXPORT_ES6=1 -s EXPORT_NAME=createFvdb \
  -s ALLOW_MEMORY_GROWTH=1 -s ENVIRONMENT=web,worker,node \
  -s EXPORTED_FUNCTIONS='["_fvdb_index_new","_fvdb_index_destroy","_fvdb_index_add","_fvdb_index_update","_fvdb_index_delete","_fvdb_index_len","_fvdb_index_search","_fvdb_index_id","_fvdb_index_get","_fvdb_vec_cosine","_fvdb_vec_euclidean","_fvdb_vec_magnitude","_fvdb_vec_batch_cosine","_fvdb_kmeans_cosine","_fvdb_free","_malloc","_free"]' \
  -s EXPORTED_RUNTIME_METHODS='["ccall","cwrap","HEAPF32","HEAP32","HEAPU8"]' \
  -o fvdb_embedded.js

echo "built fvdb_embedded.js + fvdb_embedded.wasm"
