// Copied from vgan_tpu/cpp/mapfinalize.cpp (unchanged below this line).
// Batch finalize for the mapper's winning candidates (native).
//
// One call replaces the per-read Python loop of
// vgan_tpu/mapper/giraffe.py::BatchedMapper._finalize for a whole read
// batch: perfect-alignment fast path (exact substring search on the
// haplotype linearization + path-interval projection), graph-window
// alignment (graph_align, graphalign.cpp) with walk -> GAM projection
// (mirror of giraffe.py::_project_walk incl. edit merging), and the
// minus-strand flip (mirror of giraffe.py::_flip_path). Output is
// columnar (mappings/edits as flat arrays) so Python materializes
// gam.Alignment objects from slices instead of running per-base loops.
//
// This is the production replacement for the reference's in-process
// giraffe invocation (`src/map_giraffe.cpp:82-86`) on the host side of
// the TPU mapper; the score phase stays on device (sw_pallas).
//
// Built into libgamcodec.so (see Makefile).

#include <cstdint>
#include <cstring>
#include <cmath>
#include <string>
#include <thread>
#include <vector>
#include <algorithm>

extern "C" int64_t graph_align(
    const uint8_t* q, int32_t n, const uint8_t* ref, int32_t ncols,
    const int64_t* pred_off, const int32_t* pred_idx,
    int32_t* out_ops, int32_t* out_cols, int64_t cap, int64_t* out_meta);

namespace {

constexpr int32_t BONUS = 5;  // FULL_LENGTH_BONUS (mapper/align.py)

const char CODE2CHAR[8] = {'A', 'C', 'G', 'T', 'N', '-', 'S', '?'};
const uint8_t COMP_CODE[8] = {3, 2, 1, 0, 4, 5, 6, 7};

inline char comp_char(char c) {
  switch (c) {
    case 'A': return 'T';
    case 'C': return 'G';
    case 'G': return 'C';
    case 'T': return 'A';
    default: return c;  // N,-,S,? self-complement (matches dna._COMP)
  }
}

struct EditRec {
  int32_t from_len, to_len;
  std::string seq;
  bool is_match() const { return from_len == to_len && seq.empty(); }
  bool is_sub() const { return from_len == to_len && !seq.empty(); }
  bool is_ins() const { return from_len == 0 && to_len > 0; }
  bool is_del() const { return to_len == 0 && from_len > 0; }
};

struct MapRec {
  int64_t node_id;
  int32_t off;
  uint8_t rev;
  std::vector<EditRec> edits;
};

// python round() / np round-half-even
inline int32_t mq_of(double eff, double second, bool has_second) {
  if (!has_second) return 60;
  double v = std::nearbyint(6.23 * (eff - second));
  if (v < 0) v = 0;
  if (v > 60) v = 60;
  return (int32_t)v;
}

// mirror of giraffe.py::_project_walk edit merging
void merge_edits(std::vector<EditRec>& es) {
  std::vector<EditRec> merged;
  merged.reserve(es.size());
  for (auto& e : es) {
    if (!merged.empty()) {
      EditRec& last = merged.back();
      if (last.is_match() && e.is_match()) {
        last.from_len += e.from_len;
        last.to_len += e.to_len;
        continue;
      }
      if (last.is_sub() && e.is_sub()) {
        last.from_len += e.from_len;
        last.to_len += e.to_len;
        last.seq += e.seq;
        continue;
      }
      if (last.is_del() && e.is_del()) {
        last.from_len += e.from_len;
        continue;
      }
      if (last.is_ins() && e.is_ins()) {
        last.to_len += e.to_len;
        last.seq += e.seq;
        continue;
      }
    }
    merged.push_back(std::move(e));
  }
  es = std::move(merged);
}

// mirror of giraffe.py::_flip_path
void flip_maps(std::vector<MapRec>& maps, const int64_t* node_len,
               int64_t min_id) {
  std::vector<MapRec> out;
  out.reserve(maps.size());
  for (auto it = maps.rbegin(); it != maps.rend(); ++it) {
    MapRec m;
    m.node_id = it->node_id;
    int64_t nlen = node_len[it->node_id - min_id];
    int64_t consumed = 0;
    for (auto& e : it->edits) consumed += e.from_len;
    m.off = (int32_t)(nlen - it->off - consumed);
    m.rev = it->rev ? 0 : 1;
    for (auto eit = it->edits.rbegin(); eit != it->edits.rend(); ++eit) {
      EditRec e;
      e.from_len = eit->from_len;
      e.to_len = eit->to_len;
      if (!eit->seq.empty()) {
        e.seq.resize(eit->seq.size());
        for (size_t k = 0; k < eit->seq.size(); ++k)
          e.seq[k] = comp_char(eit->seq[eit->seq.size() - 1 - k]);
      }
      m.edits.push_back(std::move(e));
    }
    out.push_back(std::move(m));
  }
  maps = std::move(out);
}

// mirror of giraffe.py::_project_path_interval (all-match projection
// of path coords [start, start+length), with one-pass flip)
void project_path_interval(
    int32_t path, int64_t start, int64_t length, bool flip,
    const int32_t* ps_node, const uint8_t* ps_rev, const int64_t* ps_start,
    const int64_t* st_beg, const int64_t* st_cnt,
    const int64_t* node_len, int64_t min_id,
    std::vector<MapRec>& maps) {
  const int64_t sb = st_beg[path];
  const int64_t sc = st_cnt[path];
  const int64_t* starts = ps_start + sb;
  int64_t end = start + length;
  // s0 = upper_bound(starts, start) - 1
  int64_t s = std::upper_bound(starts, starts + sc, start) - starts - 1;
  if (s < 0) s = 0;
  int64_t pos = start;
  std::vector<MapRec> parts;
  while (pos < end && s < sc) {
    int32_t nidx = ps_node[sb + s];
    int64_t nlen = node_len[nidx];
    int64_t off_in_node = pos - starts[s];
    int64_t take = std::min(end - pos, nlen - off_in_node);
    MapRec m;
    m.node_id = (int64_t)nidx + min_id;
    bool rev = ps_rev[sb + s] != 0;
    if (flip) {
      m.off = (int32_t)(nlen - off_in_node - take);
      m.rev = rev ? 0 : 1;
    } else {
      m.off = (int32_t)off_in_node;
      m.rev = rev ? 1 : 0;
    }
    EditRec e;
    e.from_len = (int32_t)take;
    e.to_len = (int32_t)take;
    m.edits.push_back(std::move(e));
    parts.push_back(std::move(m));
    pos += take;
    s += 1;
  }
  if (flip) std::reverse(parts.begin(), parts.end());
  maps = std::move(parts);
}

// mirror of giraffe.py::_project_walk over graph_align's op/col arrays
void project_walk(
    const int32_t* ops, const int32_t* cols, int64_t wl,
    const uint8_t* q, int64_t L, int64_t read_start,
    const int32_t* pos_handle, const int32_t* pos_offset,
    const int32_t* wh_node, const uint8_t* wh_rev, int64_t min_id,
    std::vector<MapRec>& maps) {
  maps.clear();
  std::vector<EditRec> pending;
  int32_t cur_handle = -1;
  int64_t read_pos = read_start;
  if (read_start > 0) {
    EditRec e;
    e.from_len = 0;
    e.to_len = (int32_t)read_start;
    e.seq.resize(read_start);
    for (int64_t k = 0; k < read_start; ++k) e.seq[k] = CODE2CHAR[q[k] & 7];
    pending.push_back(std::move(e));
  }
  auto push_edit = [&](EditRec&& e) {
    if (maps.empty()) {
      pending.push_back(std::move(e));
    } else {
      maps.back().edits.push_back(std::move(e));
    }
  };
  for (int64_t k = 0; k < wl; ++k) {
    int32_t op = ops[k];
    int32_t c = cols[k];
    if (op == 3) {  // I
      EditRec e;
      e.from_len = 0;
      e.to_len = 1;
      e.seq.push_back(CODE2CHAR[q[read_pos] & 7]);
      read_pos += 1;
      push_edit(std::move(e));
      continue;
    }
    int32_t h = pos_handle[c];
    if (maps.empty() || h != cur_handle) {
      MapRec m;
      m.node_id = (int64_t)wh_node[h] + min_id;
      m.off = pos_offset[c];
      m.rev = wh_rev[h];
      if (!pending.empty()) {
        m.edits = std::move(pending);
        pending.clear();
      }
      maps.push_back(std::move(m));
      cur_handle = h;
    }
    EditRec e;
    if (op == 0) {  // M
      e.from_len = 1;
      e.to_len = 1;
      read_pos += 1;
    } else if (op == 1) {  // X
      e.from_len = 1;
      e.to_len = 1;
      e.seq.push_back(CODE2CHAR[q[read_pos] & 7]);
      read_pos += 1;
    } else {  // D
      e.from_len = 1;
      e.to_len = 0;
    }
    maps.back().edits.push_back(std::move(e));
  }
  if (read_pos < L) {
    EditRec e;
    e.from_len = 0;
    e.to_len = (int32_t)(L - read_pos);
    e.seq.resize(L - read_pos);
    for (int64_t k = read_pos; k < L; ++k)
      e.seq[k - read_pos] = CODE2CHAR[q[k] & 7];
    push_edit(std::move(e));
  }
  for (auto& m : maps) merge_edits(m.edits);
}

}  // namespace

extern "C" {

// Finalize a whole batch of winning candidates. Returns 0 on success,
// -(read_index+1) on output-capacity overflow. Per-read sentinel in
// out_nmap: -2 = caller must retry this read on the slow path.
int64_t map_finalize_batch(
    // reads (forward-strand codes, concatenated)
    const uint8_t* read_buf, const int64_t* read_off, int64_t n_reads,
    // per-read winner (w_has[i]==0 -> unmapped)
    const uint8_t* w_has, const float* w_score, const float* w_second,
    const uint8_t* w_has2, const int32_t* w_path, const uint8_t* w_strand,
    const int64_t* w_lo, const int64_t* w_wlen, const int32_t* w_win,
    const int32_t* w_mq_ovr,  // >=0: fixed MQ (paired-end pair-level MQ)
    // haplotype path linearizations + steps (pooled; indexed by path id)
    const uint8_t* pc_buf, const int64_t* pc_beg,
    const int32_t* ps_node, const uint8_t* ps_rev, const int64_t* ps_start,
    const int64_t* st_beg, const int64_t* st_cnt,
    const int64_t* node_len, int64_t min_id,
    // graph windows (pooled; indexed by w_win)
    const uint8_t* wref_buf, const int64_t* wref_off,
    const int64_t* wpred_off_buf, const int64_t* wpo_beg,
    const int32_t* wpred_idx_buf, const int64_t* wpi_beg,
    const int32_t* wpos_handle, const int32_t* wpos_offset,
    const int32_t* wh_node, const uint8_t* wh_rev, const int64_t* wh_beg,
    // outputs
    int32_t* out_score, double* out_identity, int32_t* out_mq,
    int32_t* out_nmap,
    int64_t* out_m_node, int32_t* out_m_off, uint8_t* out_m_rev,
    int32_t* out_m_nedit, int64_t map_cap,
    int32_t* out_e_from, int32_t* out_e_to, int32_t* out_e_seqlen,
    int64_t edit_cap, char* out_eseq, int64_t eseq_cap,
    int64_t* out_counts /* [3] mappings, edits, eseq bytes */) {
  int64_t mi = 0, ei = 0, si = 0;

  auto emit = [&](int64_t i, int32_t score, double identity, int32_t mq,
                  std::vector<MapRec>& ms) -> bool {
    out_score[i] = score;
    out_identity[i] = identity;
    out_mq[i] = mq;
    out_nmap[i] = (int32_t)ms.size();
    if (mi + (int64_t)ms.size() > map_cap) return false;
    for (auto& m : ms) {
      out_m_node[mi] = m.node_id;
      out_m_off[mi] = m.off;
      out_m_rev[mi] = m.rev;
      out_m_nedit[mi] = (int32_t)m.edits.size();
      mi++;
      if (ei + (int64_t)m.edits.size() > edit_cap) return false;
      for (auto& e : m.edits) {
        out_e_from[ei] = e.from_len;
        out_e_to[ei] = e.to_len;
        out_e_seqlen[ei] = (int32_t)e.seq.size();
        ei++;
        if (si + (int64_t)e.seq.size() > eseq_cap) return false;
        std::memcpy(out_eseq + si, e.seq.data(), e.seq.size());
        si += e.seq.size();
      }
    }
    return true;
  };

  // phase 1 (threaded over the read range; the host has 2 cores):
  // align/project every read into per-read records
  struct ReadRes {
    int32_t score = 0;
    double identity = 0.0;
    int32_t mq = 0;
    int8_t status = 0;  // 0 unmapped, 1 mapped, -2 retry on slow path
    std::vector<MapRec> maps;
  };
  std::vector<ReadRes> res(n_reads);

  auto process_range = [&](int64_t lo, int64_t hi) {
    std::vector<uint8_t> qbuf;
    std::vector<int32_t> ops, cols;
    int64_t meta[5];
    for (int64_t i = lo; i < hi; ++i) {
      ReadRes& rr = res[i];
      if (!w_has[i]) continue;
      const int64_t L = read_off[i + 1] - read_off[i];
      const uint8_t* fwd = read_buf + read_off[i];
      const bool strand = w_strand[i] != 0;
      // oriented query
      qbuf.resize(L);
      if (strand) {
        for (int64_t k = 0; k < L; ++k)
          qbuf[k] = COMP_CODE[fwd[L - 1 - k] & 7];
      } else {
        std::memcpy(qbuf.data(), fwd, L);
      }
      const uint8_t* q = qbuf.data();
      const double score = (double)w_score[i];
      const double second = (double)w_second[i];
      const bool has2 = w_has2[i] != 0;
      const int32_t path = w_path[i];
      const int32_t mq_ovr = w_mq_ovr[i];

      // perfect full-length fast path
      if (score == (double)(L + 2 * BONUS)) {
        const uint8_t* win = pc_buf + pc_beg[path] + w_lo[i];
        const uint8_t* hit = (const uint8_t*)memmem(win, w_wlen[i], q, L);
        if (hit != nullptr) {
          int64_t off = hit - win;
          project_path_interval(path, w_lo[i] + off, L, strand, ps_node,
                                ps_rev, ps_start, st_beg, st_cnt,
                                node_len, min_id, rr.maps);
          rr.score = (int32_t)score;
          rr.identity = 1.0;
          rr.mq = mq_ovr >= 0 ? mq_ovr : mq_of(score, second, has2);
          rr.status = 1;
          continue;
        }
        if (w_win[i] < 0) {
          rr.status = -2;  // retry on slow path
          continue;
        }
      }
      if (w_win[i] < 0) {
        rr.status = -2;
        continue;
      }
      // graph-window alignment
      const int32_t w = w_win[i];
      const int64_t rb = wref_off[w];
      const int32_t ncols = (int32_t)(wref_off[w + 1] - rb);
      const int64_t cap = 4 * (L + ncols) + 8;
      ops.resize(cap);
      cols.resize(cap);
      int64_t wl = graph_align(q, (int32_t)L, wref_buf + rb, ncols,
                               wpred_off_buf + wpo_beg[w],
                               wpred_idx_buf + wpi_beg[w], ops.data(),
                               cols.data(), cap, meta);
      if (wl < 0) continue;  // unmapped
      int64_t eff = meta[0] + (meta[2] == L ? BONUS : 0);
      project_walk(ops.data(), cols.data(), wl, q, L, meta[1],
                   wpos_handle + rb, wpos_offset + rb, wh_node + wh_beg[w],
                   wh_rev + wh_beg[w], min_id, rr.maps);
      if (strand) flip_maps(rr.maps, node_len, min_id);
      rr.score = (int32_t)eff;
      rr.identity = wl > 0 ? (double)meta[3] / (double)wl : 0.0;
      rr.mq = mq_ovr >= 0 ? mq_ovr : mq_of((double)eff, second, has2);
      rr.status = 1;
    }
  };
  if (n_reads >= 256) {
    int64_t mid = n_reads / 2;
    std::thread t1(process_range, 0, mid);
    process_range(mid, n_reads);
    t1.join();
  } else {
    process_range(0, n_reads);
  }

  // phase 2 (serial): pack into the flat output arrays
  for (int64_t i = 0; i < n_reads; ++i) {
    ReadRes& rr = res[i];
    out_score[i] = 0;
    out_identity[i] = 0.0;
    out_mq[i] = 0;
    out_nmap[i] = 0;
    if (rr.status == -2) {
      out_nmap[i] = -2;
    } else if (rr.status == 1) {
      if (!emit(i, rr.score, rr.identity, rr.mq, rr.maps)) return -(i + 1);
    }
  }
  out_counts[0] = mi;
  out_counts[1] = ei;
  out_counts[2] = si;
  return 0;
}

}  // extern "C"
