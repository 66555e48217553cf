/**
 * fabstir-vectordb-tpu Node.js SDK: VectorDBSession.
 *
 * API parity with the reference's primary SDK (reference: bindings/node/
 * index.d.ts:107-242 and src/session.rs): create / addVectors / search /
 * deleteVector / deleteByMetadata / updateMetadata / saveToS5 /
 * loadUserVectors / getStats / setSchema / vacuum / destroy, the same
 * config keys (s5Portal, userSeedPhrase, sessionId, chunkSize, cacheSizeMb,
 * encryptAtRest, debug) and error codes.
 *
 * Architecture note (deliberately different from the reference): the
 * reference links its Rust engine into the Node process via napi. This
 * engine cannot live inside Node — it owns the GPU — so the session
 * runs in the serving process (fabstir_vectordb_tpu.api.server) and this
 * SDK drives it over the /api/v1 REST surface, including the session-level
 * routes (save/load/schema/vacuum/delete-by-metadata/update-metadata).
 * Scoring (1/(1+d)), _originalId preservation, schema enforcement and
 * filter semantics are all server-side, so behavior matches the Python SDK
 * exactly. No dependencies (global fetch, Node >= 18).
 */

const CODES = new Set([
  "S5_ERROR", "STORAGE_ERROR", "INDEX_ERROR", "INVALID_CONFIG",
  "SESSION_ERROR", "INVALID_INPUT", "INVALID_DATA",
]);

export class VectorDBError extends Error {
  constructor(message, code = "SESSION_ERROR") {
    super(message);
    this.code = CODES.has(code) ? code : "SESSION_ERROR";
  }
}

async function request(base, method, path, body = null, timeoutMs = 30000) {
  const ctrl = new AbortController();
  const timer = setTimeout(() => ctrl.abort(), timeoutMs);
  let resp;
  try {
    resp = await fetch(base + path, {
      method,
      headers: body != null ? { "Content-Type": "application/json" } : {},
      body: body != null ? JSON.stringify(body) : undefined,
      signal: ctrl.signal,
    });
  } catch (err) {
    throw new VectorDBError(`request failed: ${err}`, "STORAGE_ERROR");
  } finally {
    clearTimeout(timer);
  }
  let payload = null;
  try {
    payload = await resp.json();
  } catch {}
  if (!resp.ok) {
    const err = (payload && payload.error) || {};
    throw new VectorDBError(err.message || `HTTP ${resp.status}`,
                            err.code || "SESSION_ERROR");
  }
  return payload;
}

export class VectorDBSession {
  constructor(config, baseUrl) {
    this._config = config;
    this._base = baseUrl.replace(/\/$/, "") + "/api/v1";
    this._timeoutMs = config.timeoutMs ?? 30000;
    this._destroyed = false;
  }

  /**
   * Create a session. Config mirrors the reference VectorDBConfig
   * (sessionId, s5Portal, userSeedPhrase required there; here serverUrl
   * points at the serving process, default http://localhost:7533).
   */
  static async create(config) {
    for (const key of ["sessionId"]) {
      if (!config || !config[key]) {
        throw new VectorDBError(`${key} is required`, "INVALID_CONFIG");
      }
    }
    if (config.chunkSize != null && config.chunkSize <= 0) {
      throw new VectorDBError("chunkSize must be > 0", "INVALID_CONFIG");
    }
    if (config.cacheSizeMb != null && config.cacheSizeMb <= 0) {
      throw new VectorDBError("cacheSizeMb must be > 0", "INVALID_CONFIG");
    }
    const session = new VectorDBSession(
      config, config.serverUrl || "http://localhost:7533");
    await session._request("GET", "/health"); // connectivity check
    return session;
  }

  _request(method, path, body = null) {
    if (this._destroyed) {
      throw new VectorDBError("session destroyed", "SESSION_ERROR");
    }
    return request(this._base, method, path, body, this._timeoutMs);
  }

  /** vectors: [{id, vector, metadata?}] (reference addVectors). */
  async addVectors(vectors) {
    const out = await this._request("POST", "/vectors/batch", { vectors });
    if (out.failed > 0) {
      const first = out.errors[0] || {};
      throw new VectorDBError(
        `${out.failed} vector(s) failed: ${first.error || ""}`,
        "INVALID_INPUT");
    }
    return out.inserted;
  }

  /**
   * search(query, k, options) -> [{id, score, metadata, vector?}],
   * score = 1/(1+distance), options {threshold, includeVectors, filter}.
   */
  async search(query, k = 10, options = {}) {
    const body = { vector: query, k, options: {} };
    if (options.threshold != null) body.options.score_threshold = options.threshold;
    if (options.includeVectors) body.options.include_vectors = true;
    if (options.filter) body.options.filter = options.filter;
    const out = await this._request("POST", "/search", body);
    return out.results;
  }

  async getVector(id) {
    return this._request("GET", `/vectors/${encodeURIComponent(id)}`);
  }

  async deleteVector(id) {
    await this._request("DELETE", `/vectors/${encodeURIComponent(id)}`);
  }

  /** Returns {deletedCount, deletedIds} (reference DeleteResult). */
  async deleteByMetadata(filter) {
    const out = await this._request(
      "POST", "/vectors/delete-by-metadata", { filter });
    return { deletedCount: out.deletedCount, deletedIds: out.deletedIds };
  }

  async updateMetadata(id, metadata) {
    await this._request(
      "PATCH", `/vectors/${encodeURIComponent(id)}/metadata`, { metadata });
  }

  /** Persist to the object store; returns the CID (= session id). */
  async saveToS5() {
    const out = await this._request("POST", "/session/save");
    return out.cid;
  }

  /** Load a previously saved session; options {lazyLoad?} accepted. */
  async loadUserVectors(cid, options = null) {
    const out = await this._request("POST", "/session/load", { cid, options });
    return out.loaded;
  }

  /** Returns SessionStats (camelCase, reference index.d.ts:54-76). */
  async getStats() {
    return this._request("GET", "/session/stats");
  }

  async setSchema(schema) {
    await this._request("PUT", "/session/schema", { schema });
  }

  /** Returns {hnswRemoved, ivfRemoved, totalRemoved}. */
  async vacuum() {
    const out = await this._request("POST", "/session/vacuum");
    return out; // already camelCase: {hnswRemoved, ivfRemoved, totalRemoved}
  }

  async destroy() {
    this._destroyed = true;
  }
}

export default VectorDBSession;
