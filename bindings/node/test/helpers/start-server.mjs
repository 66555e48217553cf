/**
 * Spawns the serving process (fabstir_vectordb_tpu.api.server) and polls
 * /health until ready (mirrors the reference's test service bootstrap,
 * reference: bindings/node/test/helpers/start-s5-service.js:36-66).
 *
 * The repo root must be the cwd (the Python package resolves from there).
 */
import { spawn } from "node:child_process";

export async function startServer({
  port = 7914,
  dimension = 8,
  storageMode = "mock",
  repoRoot = new URL("../../../..", import.meta.url).pathname,
  timeoutMs = 60000,
} = {}) {
  const env = {
    ...process.env,
    VECTOR_DB_PORT: String(port),
    VECTOR_DIMENSION: String(dimension),
    STORAGE_MODE: storageMode,
    JAX_PLATFORMS: "cpu",
  };
  const proc = spawn("python", ["-m", "fabstir_vectordb_tpu.api.server"], {
    cwd: repoRoot,
    env,
    stdio: ["ignore", "ignore", "pipe"],
  });
  let stderr = "";
  proc.stderr.on("data", (d) => { stderr += d; });

  const base = `http://localhost:${port}`;
  const deadline = Date.now() + timeoutMs;
  while (Date.now() < deadline) {
    try {
      const r = await fetch(`${base}/api/v1/health`,
                            { signal: AbortSignal.timeout(1000) });
      if (r.ok) return { proc, base, stop: () => proc.kill("SIGTERM") };
    } catch {}
    if (proc.exitCode != null) break;
    await new Promise((res) => setTimeout(res, 500));
  }
  proc.kill("SIGKILL");
  throw new Error(`server failed to start on :${port}\n${stderr.slice(-2000)}`);
}
