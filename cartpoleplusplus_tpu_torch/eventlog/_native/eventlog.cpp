// Native event-log engine: framed, CRC-checked episode-chunk records.
//
// A copy of cartpoleplusplus_tpu/eventlog/_native/eventlog.cpp (the port
// imports nothing of the JAX package, whose modules this file's twin
// serves). Format: cartpoleplusplus_tpu/eventlog/format.md, column-major
// per-episode chunks so the host sink serializes whole device-fetched
// arrays with zero per-step work.
//
// Exposed as a C ABI for ctypes (no pybind11). The Python twin
// (writer.py) produces byte-identical files; tests assert parity, and
// tests/test_torch_eventlog.py holds both against the reference's writer.
//
// Build: c++ -O2 -shared -fPIC eventlog.cpp -o libeventlog.so  (build.py)

#include <cstdint>
#include <cstdio>
#include <cstring>
#include <string>
#include <vector>

namespace {

constexpr uint32_t kMagic = 0x45505043;  // "CPPE" little-endian
constexpr uint32_t kVersion = 1;
constexpr uint32_t kKindEpisode = 1;
constexpr uint32_t kKindMetadata = 2;

// IEEE 802.3 CRC32 (zlib-compatible), slicing-by-8: processes 8 bytes
// per iteration through 8 derived tables (~6-8x the 1-byte/iteration
// form — the CRC was the sink's throughput ceiling once segmentation
// moved native).
const uint32_t (*crc_tables())[256] {
  static uint32_t table[8][256];
  static bool init = false;
  if (!init) {
    for (uint32_t i = 0; i < 256; ++i) {
      uint32_t c = i;
      for (int k = 0; k < 8; ++k) c = (c & 1) ? 0xEDB88320u ^ (c >> 1) : c >> 1;
      table[0][i] = c;
    }
    for (uint32_t i = 0; i < 256; ++i) {
      uint32_t c = table[0][i];
      for (int s = 1; s < 8; ++s) {
        c = table[0][c & 0xFF] ^ (c >> 8);
        table[s][i] = c;
      }
    }
    init = true;
  }
  return table;
}

uint32_t crc32_update(uint32_t crc, const uint8_t* buf, size_t len) {
  const uint32_t(*t)[256] = crc_tables();
  crc ^= 0xFFFFFFFFu;
  while (len >= 8) {
    uint32_t lo, hi;
    std::memcpy(&lo, buf, 4);
    std::memcpy(&hi, buf + 4, 4);
    lo ^= crc;
    crc = t[7][lo & 0xFF] ^ t[6][(lo >> 8) & 0xFF] ^ t[5][(lo >> 16) & 0xFF] ^
          t[4][lo >> 24] ^ t[3][hi & 0xFF] ^ t[2][(hi >> 8) & 0xFF] ^
          t[1][(hi >> 16) & 0xFF] ^ t[0][hi >> 24];
    buf += 8;
    len -= 8;
  }
  while (len--) crc = t[0][(crc ^ *buf++) & 0xFF] ^ (crc >> 8);
  return crc ^ 0xFFFFFFFFu;
}

struct Writer {
  FILE* f = nullptr;
  std::vector<uint8_t> buf;  // payload staging for one record
};

void append(std::vector<uint8_t>& v, const void* p, size_t n) {
  const uint8_t* b = static_cast<const uint8_t*>(p);
  v.insert(v.end(), b, b + n);
}

template <typename T>
void append_scalar(std::vector<uint8_t>& v, T x) {
  append(v, &x, sizeof(T));  // little-endian on every supported target
}

int write_record(Writer* w, uint32_t kind) {
  uint64_t len = w->buf.size();
  uint32_t crc = crc32_update(0, w->buf.data(), w->buf.size());
  if (fwrite(&kind, 4, 1, w->f) != 1) return -1;
  if (fwrite(&len, 8, 1, w->f) != 1) return -1;
  if (len && fwrite(w->buf.data(), 1, len, w->f) != len) return -1;
  if (fwrite(&crc, 4, 1, w->f) != 1) return -1;
  w->buf.clear();
  return 0;
}

}  // namespace

extern "C" {

// Returns an opaque writer handle, or null on failure.
void* eventlog_open(const char* path) {
  FILE* f = fopen(path, "wb");
  if (!f) return nullptr;
  uint32_t hdr[2] = {kMagic, kVersion};
  if (fwrite(hdr, 4, 2, f) != 2) {
    fclose(f);
    return nullptr;
  }
  Writer* w = new Writer();
  w->f = f;
  return w;
}

// Append-mode open: continues an existing log (header is only written
// for a fresh/empty file). Returns null on IO failure.
void* eventlog_open_append(const char* path) {
  FILE* f = fopen(path, "ab");
  if (!f) return nullptr;
  long pos = ftell(f);
  if (pos < 8) {
    uint32_t hdr[2] = {kMagic, kVersion};
    if (fwrite(hdr, 4, 2, f) != 2) {
      fclose(f);
      return nullptr;
    }
  }
  Writer* w = new Writer();
  w->f = f;
  return w;
}

int eventlog_write_metadata(void* handle, const char* json, uint32_t json_len) {
  Writer* w = static_cast<Writer*>(handle);
  append_scalar<uint32_t>(w->buf, json_len);
  append(w->buf, json, json_len);
  return write_record(w, kKindMetadata);
}

// Arrays are column-major per chunk: state[T*D], action[T*A], reward[T],
// done[T], frames[T*F] (frames may be null when frame_len == 0).
// Streamed: the record length is computable up front, so each array is
// CRC'd and fwritten directly — no staging copy (the copy + 1-byte CRC
// were the sink's bandwidth ceiling; docs/design.md §13).
int eventlog_write_chunk(void* handle, uint64_t episode_id, uint32_t env_id,
                         uint32_t num_steps, uint32_t state_dim,
                         uint32_t action_dim, uint32_t frame_len,
                         const float* state, const float* action,
                         const float* reward, const uint8_t* done,
                         const uint8_t* frames) {
  Writer* w = static_cast<Writer*>(handle);
  const size_t t = num_steps;
  uint8_t head[28];
  std::memcpy(head, &episode_id, 8);
  std::memcpy(head + 8, &env_id, 4);
  std::memcpy(head + 12, &num_steps, 4);
  std::memcpy(head + 16, &state_dim, 4);
  std::memcpy(head + 20, &action_dim, 4);
  std::memcpy(head + 24, &frame_len, 4);
  const struct {
    const void* p;
    size_t n;
  } parts[] = {
      {head, sizeof(head)},
      {state, sizeof(float) * t * state_dim},
      {action, sizeof(float) * t * action_dim},
      {reward, sizeof(float) * t},
      {done, t},
      {frames, frame_len ? (size_t)t * frame_len : 0},
  };
  uint64_t len = 0;
  for (const auto& part : parts) len += part.n;
  uint32_t kind = kKindEpisode;
  if (fwrite(&kind, 4, 1, w->f) != 1) return -1;
  if (fwrite(&len, 8, 1, w->f) != 1) return -1;
  // Incremental zlib-style CRC: chain the finalized value through
  // (crc32(b, a || b) == crc32_update(crc32(a), b) in zlib semantics).
  uint32_t crc = 0;
  for (const auto& part : parts) {
    if (!part.n) continue;
    crc = crc32_update(crc, static_cast<const uint8_t*>(part.p), part.n);
    if (fwrite(part.p, 1, part.n, w->f) != part.n) return -1;
  }
  if (fwrite(&crc, 4, 1, w->f) != 1) return -1;
  return 0;
}

// The whole per-train-step trace path in one call: split a fetched
// rollout chunk (batch-major arrays over B envs x T steps) into per-env
// episode segments at `done` boundaries and write one episode-chunk
// record per segment, advancing the per-env episode counters in place.
//
// This replaces EpisodeSink.add_rollout's per-env Python loop — the
// host-side sink ceiling documented in docs/design.md §13 was ~0.25M
// env-steps/s and was dominated by B Python iterations per train step,
// not by IO. Segmentation semantics are EXACTLY the Python sink's
// (byte-identical files, tests assert it): segments end after each done
// step; a trailing unfinished segment is written without advancing the
// episode id.
//
// state (B,T,D) f32; action (B,T,A) f32; reward (B,T) f32; done (B,T)
// u8; frames (B,T,F) u8 or null. Returns the number of chunk records
// written, or -1 on IO error.
int64_t eventlog_write_rollout(void* handle, int64_t* episode_ids,
                               uint32_t num_envs, uint32_t num_steps,
                               uint32_t state_dim, uint32_t action_dim,
                               uint32_t frame_len, const float* state,
                               const float* action, const float* reward,
                               const uint8_t* done, const uint8_t* frames) {
  int64_t written = 0;
  const size_t t = num_steps;
  for (uint32_t env = 0; env < num_envs; ++env) {
    const float* st = state + (size_t)env * t * state_dim;
    const float* ac = action + (size_t)env * t * action_dim;
    const float* rw = reward + (size_t)env * t;
    const uint8_t* dn = done + (size_t)env * t;
    const uint8_t* fr = frames ? frames + (size_t)env * t * frame_len
                               : nullptr;
    size_t start = 0;
    while (start < t) {
      size_t end = start;
      while (end < t && !dn[end]) ++end;
      bool finished = end < t;  // dn[end] is the terminal step
      if (finished) ++end;      // segment includes the done step
      int rc = eventlog_write_chunk(
          handle, (uint64_t)episode_ids[env], env, (uint32_t)(end - start),
          state_dim, action_dim, frame_len, st + start * state_dim,
          ac + start * action_dim, rw + start, dn + start,
          fr ? fr + start * frame_len : nullptr);
      if (rc != 0) return -1;
      ++written;
      if (finished) ++episode_ids[env];
      start = end;
    }
  }
  return written;
}

int eventlog_close(void* handle) {
  Writer* w = static_cast<Writer*>(handle);
  int rc = fclose(w->f);
  delete w;
  return rc;
}

// --- reader -----------------------------------------------------------------
// Validates framing + CRC of every record; returns record count, or -1 on
// corruption / IO error. (Decoding payloads into arrays is done in Python,
// which memory-maps the file; the native layer owns integrity checking.)
int64_t eventlog_validate(const char* path) {
  FILE* f = fopen(path, "rb");
  if (!f) return -1;
  uint32_t hdr[2];
  if (fread(hdr, 4, 2, f) != 2 || hdr[0] != kMagic || hdr[1] != kVersion) {
    fclose(f);
    return -1;
  }
  int64_t count = 0;
  std::vector<uint8_t> payload;
  for (;;) {
    uint32_t kind;
    size_t got = fread(&kind, 4, 1, f);
    if (got == 0) break;  // clean EOF
    uint64_t len;
    if (fread(&len, 8, 1, f) != 1) goto fail;
    payload.resize(len);
    if (len && fread(payload.data(), 1, len, f) != len) goto fail;
    uint32_t crc;
    if (fread(&crc, 4, 1, f) != 1) goto fail;
    if (crc != crc32_update(0, payload.data(), payload.size())) goto fail;
    if (kind != kKindEpisode && kind != kKindMetadata) goto fail;
    ++count;
  }
  fclose(f);
  return count;
fail:
  fclose(f);
  return -1;
}

// Per-env episode index: out_max[e] = highest episode_id seen for env e
// (unchanged where an env never appears — caller pre-fills with -1).
// Walks framing only (payload header fields), skipping array bytes with
// fseek — O(records), not O(bytes). Returns record count, or -1 on
// corruption / IO error. Resume seeding (writer.py::next_episode_ids)
// uses this instead of decoding every chunk in Python.
int64_t eventlog_episode_index(const char* path, int64_t* out_max,
                               uint32_t num_envs) {
  FILE* f = fopen(path, "rb");
  if (!f) return -1;
  uint32_t hdr[2];
  if (fread(hdr, 4, 2, f) != 2 || hdr[0] != kMagic || hdr[1] != kVersion) {
    fclose(f);
    return -1;
  }
  int64_t count = 0;
  for (;;) {
    uint32_t kind;
    if (fread(&kind, 4, 1, f) == 0) break;  // clean EOF
    uint64_t len;
    if (fread(&len, 8, 1, f) != 1) goto fail;
    if (kind == kKindEpisode) {
      if (len < 28) goto fail;
      uint64_t episode_id;
      uint32_t env_id;
      if (fread(&episode_id, 8, 1, f) != 1) goto fail;
      if (fread(&env_id, 4, 1, f) != 1) goto fail;
      if (env_id < num_envs &&
          (int64_t)episode_id > out_max[env_id]) {
        out_max[env_id] = (int64_t)episode_id;
      }
      if (fseek(f, (long)(len - 12 + 4), SEEK_CUR) != 0) goto fail;
    } else if (kind == kKindMetadata) {
      if (fseek(f, (long)(len + 4), SEEK_CUR) != 0) goto fail;
    } else {
      goto fail;
    }
    ++count;
  }
  fclose(f);
  return count;
fail:
  fclose(f);
  return -1;
}

}  // extern "C"
