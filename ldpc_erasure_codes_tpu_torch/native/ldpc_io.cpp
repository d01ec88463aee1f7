// Native host-side IO/runtime for ldpc_erasure_codes_tpu_torch.
//
// The port's copy of ldpc_erasure_codes_tpu/native/ldpc_io.cpp, byte for
// byte below this comment, so both packages write the same files (the
// Vlist header keeps its "generated by ldpc_erasure_codes_tpu" line). The
// host-side equivalent of the reference's C++ host-harness data path
// (OpenCL/host/src/main.cpp): golden test-vector file IO with the 16-bit
// replicate-into-symbol expansion (main.cpp:329-401), the bit-plane
// pack/transpose of packed symbol words, read/write of the generated Vlist
// C-header ROM format (OpenCL/device/LDPC_Vlist_data.h, written by
// Matlab/data_gen_for_OpenCL_erasure_codec.m:32-50), and the UDP burst
// transmit/receive and block assembler of the streaming path.
//
// Exposed as a C ABI shared library consumed through ctypes
// (ldpc_erasure_codes_tpu_torch/utils/native.py). All functions return
// >= 0 on success, < 0 on failure.

#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>

extern "C" {

// Read a reference-format vector file: one decimal value per line (extra
// comma/space separated tokens ignored, as strtok(", ") does in the
// reference). Returns the number of values read, or -1.
int ldpc_read_vector_file(const char *path, uint16_t *out, int max_n) {
  FILE *f = std::fopen(path, "rt");
  if (!f) return -1;
  char line[256];
  int cnt = 0;
  while (cnt < max_n && std::fgets(line, sizeof line, f)) {
    char *tok = std::strtok(line, ", \t\r\n");
    if (!tok) continue;
    out[cnt++] = (uint16_t)(std::atoi(tok) & 0xFFFF);
  }
  std::fclose(f);
  return cnt;
}

// Write one decimal value per line (the MATLAB writer's format).
int ldpc_write_vector_file(const char *path, const uint16_t *vals, int n) {
  FILE *f = std::fopen(path, "wt");
  if (!f) return -1;
  for (int i = 0; i < n; i++) std::fprintf(f, "%u\n", (unsigned)vals[i]);
  std::fclose(f);
  return n;
}

// Expand 16-bit values into wide packed symbols: each value is replicated
// across every 16-bit lane of `words` uint32 words per symbol, and value 0
// marks an erasure (the reference's in-band convention, main.cpp:380-387).
int ldpc_expand_symbols(const uint16_t *vals, int n, int words,
                        uint32_t *symbols, uint8_t *erased) {
  for (int i = 0; i < n; i++) {
    uint32_t v = vals[i];
    uint32_t w = v | (v << 16);
    erased[i] = (v == 0) ? 1 : 0;
    uint32_t fill = erased[i] ? 0u : w;
    for (int j = 0; j < words; j++) symbols[(size_t)i * words + j] = fill;
  }
  return n;
}

// Collapse wide packed symbols back to 16-bit values; returns -2 if any
// symbol's lanes disagree (corrupted replication).
int ldpc_collapse_symbols(const uint32_t *symbols, int n, int words,
                          uint16_t *vals) {
  for (int i = 0; i < n; i++) {
    uint32_t w0 = symbols[(size_t)i * words];
    uint16_t v = (uint16_t)(w0 & 0xFFFF);
    if ((w0 >> 16) != v) return -2;
    for (int j = 1; j < words; j++)
      if (symbols[(size_t)i * words + j] != w0) return -2;
    vals[i] = v;
  }
  return n;
}

// Bit-plane pack: bits (b, s, n) row-major {0,1} bytes -> packed words
// (b, n, s/32) uint32, bit t of word w = plane s = 32*w + t (LSB-first).
// This is the host-side transpose between the MXU-friendly bit-plane layout
// and the VPU-friendly packed-word layout.
int ldpc_pack_bitplanes(const uint8_t *bits, int b, int s, int n,
                        uint32_t *packed) {
  if (s % 32) return -1;
  int w = s / 32;
  std::memset(packed, 0, (size_t)b * n * w * sizeof(uint32_t));
  for (int bb = 0; bb < b; bb++) {
    const uint8_t *src = bits + (size_t)bb * s * n;
    uint32_t *dst = packed + (size_t)bb * n * w;
    for (int ss = 0; ss < s; ss++) {
      uint32_t mask = 1u << (ss & 31);
      int word = ss >> 5;
      const uint8_t *row = src + (size_t)ss * n;
      for (int col = 0; col < n; col++)
        if (row[col]) dst[(size_t)col * w + word] |= mask;
    }
  }
  return 0;
}

// Inverse of ldpc_pack_bitplanes.
int ldpc_unpack_bitplanes(const uint32_t *packed, int b, int s, int n,
                          uint8_t *bits) {
  if (s % 32) return -1;
  int w = s / 32;
  for (int bb = 0; bb < b; bb++) {
    const uint32_t *src = packed + (size_t)bb * n * w;
    uint8_t *dst = bits + (size_t)bb * s * n;
    for (int ss = 0; ss < s; ss++) {
      uint32_t mask = 1u << (ss & 31);
      int word = ss >> 5;
      uint8_t *row = dst + (size_t)ss * n;
      for (int col = 0; col < n; col++)
        row[col] = (src[(size_t)col * w + word] & mask) ? 1 : 0;
    }
  }
  return 0;
}

// Write a Vlist ROM header in the reference's generated-C format: a 2-D
// array literal, one row per check: {degree, 1-based column indices...,
// zero padding} with `cols` entries per row.
int ldpc_write_vlist_header(const char *path, const char *array_name,
                            const int32_t *vlist_idx, const int32_t *vlist_len,
                            int m, int dmax, int cols) {
  if (cols < dmax + 1) return -1;
  FILE *f = std::fopen(path, "wt");
  if (!f) return -1;
  std::fprintf(f, "// generated by ldpc_erasure_codes_tpu (Vlist ROM)\n");
  std::fprintf(f, "int %s[%d][%d] = {\n", array_name, m, cols);
  for (int r = 0; r < m; r++) {
    int d = vlist_len[r];
    std::fprintf(f, "{%d", d);
    for (int j = 0; j < d; j++)
      std::fprintf(f, ",%d", vlist_idx[r * dmax + j] + 1);
    for (int j = d + 1; j < cols; j++) std::fprintf(f, ",0");
    std::fprintf(f, "}%s\n", r + 1 < m ? "," : "");
  }
  std::fprintf(f, "};\n");
  std::fclose(f);
  return m;
}

// Parse every integer in the first {...} array body found in a C header.
// Returns the number of integers written to `out` (row structure is
// recovered by the caller from the declared column count), or -1.
int ldpc_parse_vlist_header(const char *path, int32_t *out, int max_vals) {
  FILE *f = std::fopen(path, "rt");
  if (!f) return -1;
  int c, depth = 0, cnt = 0;
  long val = 0;
  int in_num = 0, neg = 0;
  int started = 0;
  while ((c = std::fgetc(f)) != EOF) {
    if (c == '/') {  // skip // and /* */ comments
      int c2 = std::fgetc(f);
      if (c2 == '/') {
        while ((c2 = std::fgetc(f)) != EOF && c2 != '\n') {}
        c = ' ';
      } else if (c2 == '*') {
        int prev = 0;
        while ((c2 = std::fgetc(f)) != EOF && !(prev == '*' && c2 == '/'))
          prev = c2;
        c = ' ';
      } else if (c2 != EOF) {
        std::ungetc(c2, f);
      }
    }
    if (c == '{') {
      depth++;
      started = 1;
      continue;
    }
    if (c == '}') {
      if (in_num && cnt < max_vals) out[cnt++] = (int32_t)(neg ? -val : val);
      in_num = 0;
      val = 0;
      neg = 0;
      depth--;
      if (started && depth <= 0) break;
      continue;
    }
    if (depth <= 0) continue;
    if (c == '-') {
      neg = 1;
      in_num = 1;
      continue;
    }
    if (c >= '0' && c <= '9') {
      val = val * 10 + (c - '0');
      in_num = 1;
      continue;
    }
    if (in_num) {
      if (cnt < max_vals) out[cnt++] = (int32_t)(neg ? -val : val);
      in_num = 0;
      val = 0;
      neg = 0;
    }
  }
  std::fclose(f);
  return cnt;
}

}  // extern "C"

// ---------------------------------------------------------------------------
// FEC packet-stream block assembler (native runtime for utils/streaming.py).
//
// Same semantics as the Python BlockAssembler (the reference's reordering
// sketch, OpenCL/device/ldpc_erasure_decoder_with_reordering_logic.cl:17-26):
// 8-byte little-endian header {class u16, block u32, symbol u16}, bounded
// in-flight window with oldest-first eviction, decode-at-k / full-n drain
// triggers, duplicate and late-straggler accounting. The Python
// implementation is per-packet interpreter-bound; this one assembles bursts
// of datagrams at memcpy speed (production data-loader path).
// ---------------------------------------------------------------------------

#include <deque>
#include <unordered_map>
#include <unordered_set>
#include <vector>

namespace {

struct AsmBlock {
  std::vector<uint8_t> values;    // n * symbol_bytes
  std::vector<uint8_t> received;  // n
  int count = 0;
};

struct Assembler {
  int n, k, symbol_bytes, max_blocks, decode_at_k;
  size_t completed_cap;
  std::unordered_map<uint32_t, AsmBlock> blocks;
  std::deque<uint32_t> order;  // insertion order of in-flight blocks
  struct Ready {
    uint32_t num;
    std::vector<uint8_t> values;
    std::vector<uint8_t> received;
  };
  std::deque<Ready> ready;
  std::unordered_set<uint32_t> completed;
  std::deque<uint32_t> completed_order;
  long long stats[6] = {0, 0, 0, 0, 0, 0};
  // [packets, duplicates, late, bad, blocks_out, evictions]

  void finish(uint32_t num, AsmBlock&& b) {
    ready.push_back({num, std::move(b.values), std::move(b.received)});
    stats[4]++;
    completed.insert(num);
    completed_order.push_back(num);
    while (completed_order.size() > completed_cap) {
      completed.erase(completed_order.front());
      completed_order.pop_front();
    }
  }

  void pop_inflight(uint32_t num) {
    blocks.erase(num);
    for (auto it = order.begin(); it != order.end(); ++it) {
      if (*it == num) {
        order.erase(it);
        break;
      }
    }
  }
};

}  // namespace

extern "C" {

void* ldpc_asm_create(int n, int k, int symbol_bytes, int max_blocks,
                      int decode_at_k) {
  auto* a = new Assembler();
  a->n = n;
  a->k = k;
  a->symbol_bytes = symbol_bytes;
  a->max_blocks = max_blocks;
  a->decode_at_k = decode_at_k;
  a->completed_cap = (size_t)(max_blocks * 4 > 64 ? max_blocks * 4 : 64);
  return a;
}

void ldpc_asm_destroy(void* h) { delete (Assembler*)h; }

// Push `count` packets laid out at `stride` bytes apart; each is the 8-byte
// header + symbol_bytes payload (callers with exact-size packets pass
// stride = 8 + symbol_bytes). `sizes` may be null (all packets full size) or
// per-packet actual sizes for bad-length accounting.
void ldpc_asm_push(void* h, const uint8_t* data, const int32_t* sizes,
                   int count, int stride) {
  auto* a = (Assembler*)h;
  const int want = 8 + a->symbol_bytes;
  for (int i = 0; i < count; i++) {
    const uint8_t* p = data + (size_t)i * stride;
    a->stats[0]++;
    if (sizes && sizes[i] != want) {
      a->stats[3]++;
      continue;
    }
    uint32_t block;
    uint16_t sym;
    std::memcpy(&block, p + 2, 4);
    std::memcpy(&sym, p + 6, 2);
    if (sym >= a->n) {
      a->stats[3]++;
      continue;
    }
    if (a->completed.count(block)) {
      a->stats[2]++;
      continue;
    }
    auto it = a->blocks.find(block);
    if (it == a->blocks.end()) {
      AsmBlock b;
      b.values.assign((size_t)a->n * a->symbol_bytes, 0);
      b.received.assign(a->n, 0);
      it = a->blocks.emplace(block, std::move(b)).first;
      a->order.push_back(block);
      while ((int)a->blocks.size() > a->max_blocks) {
        uint32_t old = a->order.front();
        a->order.pop_front();
        auto oit = a->blocks.find(old);
        a->finish(old, std::move(oit->second));
        a->blocks.erase(oit);
        a->stats[5]++;
      }
      it = a->blocks.find(block);
      if (it == a->blocks.end()) {
        // The new block itself was evicted (max_blocks tiny) — the packet
        // was consumed into the drained (mostly-erased) block... but finish
        // happened before the write; count it as received-after-drain.
        a->stats[2]++;
        continue;
      }
    }
    AsmBlock& b = it->second;
    if (b.received[sym]) {
      a->stats[1]++;
      continue;
    }
    b.received[sym] = 1;
    std::memcpy(&b.values[(size_t)sym * a->symbol_bytes], p + 8,
                a->symbol_bytes);
    b.count++;
    if (b.count == a->n || (a->decode_at_k && b.count >= a->k)) {
      AsmBlock done = std::move(b);
      a->pop_inflight(block);
      a->finish(block, std::move(done));
    }
  }
}

int ldpc_asm_ready(void* h) { return (int)((Assembler*)h)->ready.size(); }

void ldpc_asm_flush(void* h) {
  auto* a = (Assembler*)h;
  while (!a->order.empty()) {
    uint32_t num = a->order.front();
    a->order.pop_front();
    auto it = a->blocks.find(num);
    if (it != a->blocks.end()) {
      a->finish(num, std::move(it->second));
      a->blocks.erase(it);
    }
  }
}

// Drain up to max_out blocks: nums int64[max_out],
// values uint8[max_out, n, symbol_bytes], erased uint8[max_out, n].
int ldpc_asm_drain(void* h, long long* nums, uint8_t* values, uint8_t* erased,
                   int max_out) {
  auto* a = (Assembler*)h;
  int out = 0;
  while (out < max_out && !a->ready.empty()) {
    auto& r = a->ready.front();
    nums[out] = (long long)r.num;
    std::memcpy(values + (size_t)out * a->n * a->symbol_bytes,
                r.values.data(), (size_t)a->n * a->symbol_bytes);
    for (int s = 0; s < a->n; s++)
      erased[(size_t)out * a->n + s] = r.received[s] ? 0 : 1;
    a->ready.pop_front();
    out++;
  }
  return out;
}

void ldpc_asm_stats(void* h, long long* out6) {
  std::memcpy(out6, ((Assembler*)h)->stats, 6 * sizeof(long long));
}

}  // extern "C"

// ---------------------------------------------------------------------------
// Burst transmit side — the native mirror of the RX-side assembler.
//
// The reference's production encoder emits each repair symbol as a UDP
// datagram with the 8-byte FEC header at line rate in hardware
// (OpenCL/device/ldpc_erasure_encoder_VITA_in_UDP_out.cl:84-136). The
// round-2 Python send path (one struct.pack + sendto per datagram) measured
// 67.3k pkts/s and was the end-to-end bottleneck; here packetization is one
// C pass over the block matrix and transmission is sendmmsg() in bursts —
// one syscall per 512 datagrams.
// ---------------------------------------------------------------------------

#include <arpa/inet.h>
#include <errno.h>
#include <netinet/in.h>
#include <sys/socket.h>
#include <time.h>

extern "C" {

// Packetize encoded blocks into a contiguous packet matrix.
//   blocks: (b, n, sb) uint8 symbol payloads.
//   order:  int64[npkts] flat (block * n + symbol) indices to emit, in
//           transmit order — the caller expresses loss injection (omit
//           entries) and stream shuffling (permute entries) here.
//   out:    uint8[npkts, 8 + sb]; header = {class u16, block u32, sym u16}
//           little-endian (streaming.pack_header layout).
// Returns npkts, or -1 on an out-of-range index.
int ldpc_tx_packetize(const uint8_t* blocks, int b, int n, int sb,
                      int class_code, long long first_block_num,
                      const long long* order, int npkts, uint8_t* out) {
  const size_t psize = 8 + (size_t)sb;
  for (int i = 0; i < npkts; i++) {
    long long idx = order[i];
    if (idx < 0 || idx >= (long long)b * n) return -1;
    uint32_t blk = (uint32_t)(first_block_num + idx / n);
    uint16_t sym = (uint16_t)(idx % n);
    uint16_t cls = (uint16_t)class_code;
    uint8_t* p = out + (size_t)i * psize;
    std::memcpy(p, &cls, 2);
    std::memcpy(p + 2, &blk, 4);
    std::memcpy(p + 6, &sym, 2);
    std::memcpy(p + 8, blocks + (size_t)idx * sb, (size_t)sb);
  }
  return npkts;
}

// Send npkts fixed-size datagrams from a contiguous packet matrix to ip:port
// over the caller's (already-created) UDP socket fd, via sendmmsg in bursts
// of 512. Transient backpressure (EAGAIN/ENOBUFS — loopback receivers) gets
// a 200 us yield then retry. Returns datagrams sent, or -errno.
// Drain up to max_pkts datagrams from fd (non-blocking) into a contiguous
// (max_pkts, stride) matrix; sizes[i] = received datagram length (truncated
// to stride). Returns the number drained (0 if none ready), or -errno on a
// real error. One recvmmsg syscall per 512 datagrams — the RX mirror of
// ldpc_udp_send_burst; feeds ldpc_asm_push's burst path directly.
int ldpc_udp_recv_burst(int fd, uint8_t* out, int max_pkts, int stride,
                        int32_t* sizes) {
  enum { kBurst = 512 };
  static thread_local mmsghdr hdrs[kBurst];
  static thread_local iovec iovs[kBurst];
  int total = 0;
  while (total < max_pkts) {
    int nb = max_pkts - total < kBurst ? max_pkts - total : kBurst;
    for (int i = 0; i < nb; i++) {
      iovs[i].iov_base = out + (size_t)(total + i) * stride;
      iovs[i].iov_len = (size_t)stride;
      std::memset(&hdrs[i], 0, sizeof(mmsghdr));
      hdrs[i].msg_hdr.msg_iov = &iovs[i];
      hdrs[i].msg_hdr.msg_iovlen = 1;
    }
    int r = recvmmsg(fd, hdrs, (unsigned)nb, MSG_DONTWAIT, nullptr);
    if (r < 0) {
      if (errno == EAGAIN || errno == EWOULDBLOCK || errno == EINTR) break;
      return total > 0 ? total : -errno;
    }
    for (int i = 0; i < r; i++) sizes[total + i] = (int32_t)hdrs[i].msg_len;
    total += r;
    if (r < nb) break;
  }
  return total;
}

// GRO-aware burst receive: like ldpc_udp_recv_burst but each row may hold
// a kernel-coalesced chunk of many equal-size datagrams (the receive-side
// mirror of ldpc_udp_send_gso — on loopback the GSO super-skb is delivered
// whole to a UDP_GRO socket, so one recv covers up to 61 datagrams).
// segs[i] = the chunk's segment size from the UDP_GRO cmsg, or 0 for an
// ordinary un-coalesced datagram; sizes[i] = total chunk bytes.
int ldpc_udp_recv_gro(int fd, uint8_t* out, int max_chunks, int stride,
                      int32_t* sizes, int32_t* segs) {
#ifndef UDP_GRO
#define UDP_GRO 104
#endif
  enum { kBurst = 64 };
  static thread_local mmsghdr hdrs[kBurst];
  static thread_local iovec iovs[kBurst];
  static thread_local char cbuf[kBurst][CMSG_SPACE(sizeof(int))];
  int total = 0;
  while (total < max_chunks) {
    int nb = max_chunks - total < kBurst ? max_chunks - total : kBurst;
    for (int i = 0; i < nb; i++) {
      iovs[i].iov_base = out + (size_t)(total + i) * stride;
      iovs[i].iov_len = (size_t)stride;
      std::memset(&hdrs[i], 0, sizeof(mmsghdr));
      hdrs[i].msg_hdr.msg_iov = &iovs[i];
      hdrs[i].msg_hdr.msg_iovlen = 1;
      hdrs[i].msg_hdr.msg_control = cbuf[i];
      hdrs[i].msg_hdr.msg_controllen = CMSG_SPACE(sizeof(int));
    }
    int r = recvmmsg(fd, hdrs, (unsigned)nb, MSG_DONTWAIT, nullptr);
    if (r < 0) {
      if (errno == EAGAIN || errno == EWOULDBLOCK || errno == EINTR) break;
      return total > 0 ? total : -errno;
    }
    for (int i = 0; i < r; i++) {
      sizes[total + i] = (int32_t)hdrs[i].msg_len;
      int seg = 0;
      for (cmsghdr* cm = CMSG_FIRSTHDR(&hdrs[i].msg_hdr); cm;
           cm = CMSG_NXTHDR(&hdrs[i].msg_hdr, cm)) {
        if (cm->cmsg_level == IPPROTO_UDP && cm->cmsg_type == UDP_GRO &&
            cm->cmsg_len >= CMSG_LEN(sizeof(int))) {
          std::memcpy(&seg, CMSG_DATA(cm), sizeof(int));
        }
      }
      segs[total + i] = (int32_t)seg;
    }
    total += r;
    if (r < nb) break;
  }
  return total;
}

int ldpc_udp_send_burst(int fd, const uint8_t* pkts, int npkts, int psize,
                        const char* ip, int port) {
  sockaddr_in dst;
  std::memset(&dst, 0, sizeof(dst));
  dst.sin_family = AF_INET;
  dst.sin_port = htons((uint16_t)port);
  if (inet_pton(AF_INET, ip, &dst.sin_addr) != 1) return -1;
  enum { kBurst = 512 };
  static thread_local mmsghdr hdrs[kBurst];
  static thread_local iovec iovs[kBurst];
  int sent = 0;
  while (sent < npkts) {
    int nb = npkts - sent < kBurst ? npkts - sent : kBurst;
    for (int i = 0; i < nb; i++) {
      iovs[i].iov_base = (void*)(pkts + (size_t)(sent + i) * psize);
      iovs[i].iov_len = (size_t)psize;
      std::memset(&hdrs[i], 0, sizeof(mmsghdr));
      hdrs[i].msg_hdr.msg_iov = &iovs[i];
      hdrs[i].msg_hdr.msg_iovlen = 1;
      hdrs[i].msg_hdr.msg_name = &dst;
      hdrs[i].msg_hdr.msg_namelen = sizeof(dst);
    }
    int r = sendmmsg(fd, hdrs, (unsigned)nb, 0);
    if (r < 0) {
      if (errno == EAGAIN || errno == EWOULDBLOCK || errno == ENOBUFS ||
          errno == EINTR) {
        timespec ts;
        ts.tv_sec = 0;
        ts.tv_nsec = 200000;  // 200 us backoff, then retry
        nanosleep(&ts, nullptr);
        continue;
      }
      return -errno;
    }
    sent += r;
  }
  return sent;
}

// GSO burst transmit: consecutive equal-size datagrams ride one super-
// payload per message with a UDP_SEGMENT cmsg, so one skb traverses the
// UDP stack per GROUP of up to 61 datagrams (at psize 1064) instead of per
// datagram — the per-datagram stack cost is what bounds sendmmsg at ~0.5M
// pkts/s. Zero-copy: rows of the packet matrix are contiguous, so each
// group's iov points straight into it. Returns datagrams sent, or -errno
// (a hard error before anything was sent lets the caller fall back to
// ldpc_udp_send_burst on kernels without UDP GSO).
int ldpc_udp_send_gso(int fd, const uint8_t* pkts, int npkts, int psize,
                      const char* ip, int port) {
#ifndef UDP_SEGMENT
#define UDP_SEGMENT 103
#endif
  sockaddr_in dst;
  std::memset(&dst, 0, sizeof(dst));
  dst.sin_family = AF_INET;
  dst.sin_port = htons((uint16_t)port);
  if (inet_pton(AF_INET, ip, &dst.sin_addr) != 1) return -1;
  int nseg = 65507 / psize;
  if (nseg > 64) nseg = 64;
  if (nseg < 2) return ldpc_udp_send_burst(fd, pkts, npkts, psize, ip, port);
  enum { kBurst = 128 };
  static thread_local mmsghdr hdrs[kBurst];
  static thread_local iovec iovs[kBurst];
  static thread_local char cbuf[kBurst][CMSG_SPACE(sizeof(uint16_t))];
  int ngroups = (npkts + nseg - 1) / nseg;
  int sent_groups = 0;
  while (sent_groups < ngroups) {
    int nb = ngroups - sent_groups < kBurst ? ngroups - sent_groups : kBurst;
    for (int i = 0; i < nb; i++) {
      int g0 = (sent_groups + i) * nseg;
      int gcount = npkts - g0 < nseg ? npkts - g0 : nseg;
      iovs[i].iov_base = (void*)(pkts + (size_t)g0 * psize);
      iovs[i].iov_len = (size_t)gcount * psize;
      std::memset(&hdrs[i], 0, sizeof(mmsghdr));
      hdrs[i].msg_hdr.msg_iov = &iovs[i];
      hdrs[i].msg_hdr.msg_iovlen = 1;
      hdrs[i].msg_hdr.msg_name = &dst;
      hdrs[i].msg_hdr.msg_namelen = sizeof(dst);
      if (gcount > 1) {
        hdrs[i].msg_hdr.msg_control = cbuf[i];
        hdrs[i].msg_hdr.msg_controllen = CMSG_SPACE(sizeof(uint16_t));
        cmsghdr* cm = CMSG_FIRSTHDR(&hdrs[i].msg_hdr);
        cm->cmsg_level = IPPROTO_UDP;
        cm->cmsg_type = UDP_SEGMENT;
        cm->cmsg_len = CMSG_LEN(sizeof(uint16_t));
        uint16_t seg = (uint16_t)psize;
        std::memcpy(CMSG_DATA(cm), &seg, sizeof(seg));
      }
    }
    int r = sendmmsg(fd, hdrs, (unsigned)nb, 0);
    if (r < 0) {
      if (errno == EAGAIN || errno == EWOULDBLOCK || errno == ENOBUFS ||
          errno == EINTR) {
        timespec ts;
        ts.tv_sec = 0;
        ts.tv_nsec = 200000;  // 200 us backoff, then retry
        nanosleep(&ts, nullptr);
        continue;
      }
      return -errno;
    }
    sent_groups += r;
  }
  return npkts;
}

// Zero-materialization gather TX: packetize + GSO transmit fused. Each
// GSO segment is [8-byte FEC header | payload row] described by two
// iovecs — the header from a per-burst scratch, the payload pointing
// straight into the caller's (b, n, sb) block matrix (any emit order:
// loss injection / shuffle just permute `order`). The kernel gathers
// during the copy it must do anyway, so the user-space packet matrix
// (and its ~0.16 GB/s first-touch page-fault cost per fresh 33 MB
// allocation — the measured TX bottleneck at 1 KB symbols) disappears.
// Returns datagrams sent, -1 on a bad order index, or -errno.
int ldpc_udp_send_gso_gather(int fd, const uint8_t* blocks, int b, int n,
                             int sb, int class_code,
                             long long first_block_num,
                             const long long* order, int npkts,
                             const char* ip, int port) {
  sockaddr_in dst;
  std::memset(&dst, 0, sizeof(dst));
  dst.sin_family = AF_INET;
  dst.sin_port = htons((uint16_t)port);
  if (inet_pton(AF_INET, ip, &dst.sin_addr) != 1) return -1;
  const size_t psize = 8 + (size_t)sb;
  int nseg = (int)(65507 / psize);
  if (nseg > 64) nseg = 64;
  if (nseg < 1) return -1;  // symbol larger than one datagram can carry
  enum { kMsgs = 32, kMaxSeg = 64 };
  static thread_local mmsghdr hdrs[kMsgs];
  static thread_local iovec iovs[kMsgs][2 * kMaxSeg];
  static thread_local uint8_t hscratch[kMsgs][kMaxSeg][8];
  static thread_local char cbuf[kMsgs][CMSG_SPACE(sizeof(uint16_t))];
  int ngroups = (npkts + nseg - 1) / nseg;
  int sent_groups = 0;
  while (sent_groups < ngroups) {
    int nb = ngroups - sent_groups < kMsgs ? ngroups - sent_groups : kMsgs;
    for (int m = 0; m < nb; m++) {
      int g0 = (sent_groups + m) * nseg;
      int gcount = npkts - g0 < nseg ? npkts - g0 : nseg;
      for (int s = 0; s < gcount; s++) {
        long long idx = order[g0 + s];
        if (idx < 0 || idx >= (long long)b * n) return -1;
        uint32_t blk = (uint32_t)(first_block_num + idx / n);
        uint16_t sym = (uint16_t)(idx % n);
        uint16_t cls = (uint16_t)class_code;
        uint8_t* h = hscratch[m][s];
        std::memcpy(h, &cls, 2);
        std::memcpy(h + 2, &blk, 4);
        std::memcpy(h + 6, &sym, 2);
        iovs[m][2 * s].iov_base = h;
        iovs[m][2 * s].iov_len = 8;
        iovs[m][2 * s + 1].iov_base = (void*)(blocks + (size_t)idx * sb);
        iovs[m][2 * s + 1].iov_len = (size_t)sb;
      }
      std::memset(&hdrs[m], 0, sizeof(mmsghdr));
      hdrs[m].msg_hdr.msg_iov = iovs[m];
      hdrs[m].msg_hdr.msg_iovlen = 2 * gcount;
      hdrs[m].msg_hdr.msg_name = &dst;
      hdrs[m].msg_hdr.msg_namelen = sizeof(dst);
      if (gcount > 1) {
        hdrs[m].msg_hdr.msg_control = cbuf[m];
        hdrs[m].msg_hdr.msg_controllen = CMSG_SPACE(sizeof(uint16_t));
        cmsghdr* cm = CMSG_FIRSTHDR(&hdrs[m].msg_hdr);
        cm->cmsg_level = IPPROTO_UDP;
        cm->cmsg_type = UDP_SEGMENT;
        cm->cmsg_len = CMSG_LEN(sizeof(uint16_t));
        uint16_t seg = (uint16_t)psize;
        std::memcpy(CMSG_DATA(cm), &seg, sizeof(seg));
      }
    }
    int r = sendmmsg(fd, hdrs, (unsigned)nb, 0);
    if (r < 0) {
      if (errno == EAGAIN || errno == EWOULDBLOCK || errno == ENOBUFS ||
          errno == EINTR) {
        timespec ts;
        ts.tv_sec = 0;
        ts.tv_nsec = 200000;  // 200 us backoff, then retry
        nanosleep(&ts, nullptr);
        continue;
      }
      return -errno;
    }
    sent_groups += r;
  }
  return npkts;
}

}  // extern "C"
