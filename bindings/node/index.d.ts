/**
 * Type declarations for the fabstir-vectordb-tpu Node.js SDK
 * (./index.mjs). Contract parity with the reference SDK's generated
 * declarations (reference: bindings/node/index.d.ts:6-242), adapted to
 * this SDK's transport: the engine owns the GPU and runs in the
 * serving process, so the session drives it over /api/v1 REST instead of
 * an in-process napi addon.
 */

/** JSON value accepted as vector metadata. */
export type Metadata = unknown;

/**
 * MongoDB-style metadata filter (8 operators, parity with the reference
 * filter grammar — reference src/core/metadata_filter.rs:32-59):
 *   { field: value }                        — equality (implicit AND across fields)
 *   { field: { $in: [...] } }               — membership
 *   { field: { $gt|$gte|$lt|$lte: n } }     — range (mixing $gt+$gte errors)
 *   { $and: [f, ...] } / { $or: [f, ...] }  — combinators
 * Dot-notation nested paths and array-contains semantics are supported.
 */
export type MetadataFilter = Record<string, unknown>;

export interface VectorDBConfig {
  /** Unique session identifier (required). */
  sessionId: string;
  /** Serving-process origin (default: "http://localhost:7533"). */
  serverUrl?: string;
  /** S5 portal URL — forwarded to the serving process's storage factory. */
  s5Portal?: string;
  /** User seed phrase for S5-backed storage modes. */
  userSeedPhrase?: string;
  /** Memory budget in MB (default: 512). */
  memoryBudgetMb?: number;
  /** Enable debug logging (default: false). */
  debug?: boolean;
  /** Encrypt vectors at rest (default: true). */
  encryptAtRest?: boolean;
  /** Vectors per storage chunk (default: 10000); must be > 0. */
  chunkSize?: number;
  /** Chunk-cache size in MB (default: 150); must be > 0. */
  cacheSizeMb?: number;
  /** Per-request timeout in milliseconds (default: 30000). */
  timeoutMs?: number;
}

export interface LoadOptions {
  /** Register rows immediately, stream vector data on demand (default: true). */
  lazyLoad?: boolean;
  /** Override the session memory budget. */
  memoryBudgetMb?: number;
}

export interface SearchOptions {
  /** Minimum similarity score in [0, 1] (default: 0 — no threshold). */
  threshold?: number;
  /** Include raw vectors in results (default: false). */
  includeVectors?: boolean;
  /** Metadata filter (see {@link MetadataFilter}). */
  filter?: MetadataFilter;
}

export interface VectorInput {
  /** Unique identifier (preserved verbatim; never hashed away). */
  id: string;
  /** Dense embedding. */
  vector: number[];
  /** Associated metadata (any JSON value). */
  metadata?: Metadata;
}

export interface SearchResult {
  id: string;
  /** Similarity score = 1 / (1 + distance), in (0, 1]. */
  score: number;
  metadata: Metadata;
  /** Present when SearchOptions.includeVectors is set. */
  vector?: number[];
}

export interface SessionStats {
  /** Active (non-deleted) vectors across both indices. */
  vectorCount: number;
  memoryUsageMb: number;
  /** Active index type ("hnsw" | "hybrid" | ...). */
  indexType: string;
  hnswVectorCount?: number;
  ivfVectorCount?: number;
  hnswDeletedCount?: number;
  ivfDeletedCount?: number;
  totalDeletedCount?: number;
}

export interface DeleteResult {
  deletedCount: number;
  deletedIds: string[];
}

export interface VacuumStats {
  hnswRemoved: number;
  ivfRemoved: number;
  totalRemoved: number;
}

export type ErrorCode =
  | "S5_ERROR"
  | "STORAGE_ERROR"
  | "INDEX_ERROR"
  | "INVALID_CONFIG"
  | "SESSION_ERROR"
  | "INVALID_INPUT"
  | "INVALID_DATA";

export declare class VectorDBError extends Error {
  constructor(message: string, code?: ErrorCode);
  code: ErrorCode;
}

export declare class VectorDBSession {
  /** Create a session (validates config, checks server connectivity). */
  static create(config: VectorDBConfig): Promise<VectorDBSession>;

  /** Insert vectors; rejects with INVALID_INPUT if any vector fails. */
  addVectors(vectors: VectorInput[]): Promise<number>;

  /** k-NN search; score = 1/(1+distance). */
  search(
    query: number[],
    k?: number,
    options?: SearchOptions,
  ): Promise<SearchResult[]>;

  getVector(
    id: string,
  ): Promise<{ id: string; vector: number[]; metadata: Metadata }>;

  deleteVector(id: string): Promise<void>;

  /** Delete every vector whose metadata matches the filter. */
  deleteByMetadata(filter: MetadataFilter): Promise<DeleteResult>;

  /** Replace a vector's metadata (original id is preserved). */
  updateMetadata(id: string, metadata: Metadata): Promise<void>;

  /** Persist the session to the object store; resolves to the CID. */
  saveToS5(): Promise<string>;

  /** Load a previously saved session; resolves to the vector count. */
  loadUserVectors(cid: string, options?: LoadOptions | null): Promise<number>;

  getStats(): Promise<SessionStats>;

  /** Install a metadata schema enforced on subsequent addVectors. */
  setSchema(schema: Record<string, unknown>): Promise<void>;

  /** Physically remove soft-deleted vectors. */
  vacuum(): Promise<VacuumStats>;

  /** Invalidate the session handle (subsequent calls throw SESSION_ERROR). */
  destroy(): Promise<void>;
}

export default VectorDBSession;
