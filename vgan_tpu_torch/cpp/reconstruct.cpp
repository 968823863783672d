// Copied from vgan_tpu/cpp/reconstruct.cpp (unchanged below this line).
// Batch alignment reconstruction (native).
//
// Columnar mirror of vgan_tpu/graph/reconstruct.py::
// reconstruct_graph_sequence (itself `src/vgan_utils.h:6-79`), run for
// a whole alignment table in one call. Preserves the reference quirks
// exactly (they are golden-tested):
//  * softclip 'S' only for a leading insertion of mapping 0 at
//    running offset 0; end softclips stay '-';
//  * deletions splice '-' runs into the read string at the running
//    FROM-length position f (a to-length string indexed by from-length
//    counts);
//  * mppg_sizes gets one entry per EDIT (not per mapping).
//
// Outputs are dna code arrays (A,C,G,T,N,-,S,? = 0..7), ready for the
// device scorer without a host re-encode.
//
// Built into libgamcodec.so (see Makefile).

#include <cstdint>
#include <cstring>
#include <string>
#include <vector>

namespace {

constexpr uint8_t GAP = 5, SOFTCLIP = 6, RARE = 7;

inline uint8_t comp(uint8_t c) {
  static const uint8_t C[8] = {3, 2, 1, 0, 4, 5, 6, 7};
  return C[c & 7];
}

uint8_t char2code(char ch) {
  switch (ch) {
    case 'A': case 'a': return 0;
    case 'C': case 'c': return 1;
    case 'G': case 'g': return 2;
    case 'T': case 't': return 3;
    case 'N': case 'n': return 4;
    case '-': return GAP;
    case 'S': return SOFTCLIP;
    default: return RARE;
  }
}

}  // namespace

extern "C" {

// Returns 0 on success, -(aln+1) on output overflow.
// Per alignment i the outputs land at out_g[g_off[i]..] (graph codes),
// out_r[r_off[i]..] (read codes incl spliced gaps) and
// out_sizes[s_off[i]..] (per-edit aligned lengths); the caller reads
// lengths back from out_g_len / out_r_len / out_s_len.
int64_t reconstruct_batch(
    int64_t n_alns,
    const int64_t* map_off,   // [n+1] mapping ranges per alignment
    const int64_t* m_node,    // [M] node ids
    const int32_t* m_offset,  // [M]
    const uint8_t* m_rev,     // [M]
    const int64_t* e_off,     // [M+1] edit ranges per mapping
    const int32_t* e_from, const int32_t* e_to,  // [E]
    const int64_t* e_soff,    // [E+1] edit seq char ranges
    const char* eseq,
    const uint8_t* node_pool, const int64_t* node_off, int64_t min_id,
    // outputs
    const int64_t* g_off, uint8_t* out_g, int64_t* out_g_len,
    const int64_t* r_off, uint8_t* out_r, int64_t* out_r_len,
    const int64_t* s_off, int32_t* out_sizes, int64_t* out_s_len,
    int64_t g_cap, int64_t r_cap, int64_t s_cap) {
  std::vector<uint8_t> nseq;
  std::string ps;
  std::vector<uint8_t> rbuf;
  for (int64_t a = 0; a < n_alns; ++a) {
    int64_t gp = g_off[a];
    int64_t sp = s_off[a];
    const int64_t m0 = map_off[a], m1 = map_off[a + 1];

    // pass 1: path_string (edit-projected read)
    rbuf.clear();
    for (int64_t m = m0; m < m1; ++m) {
      const int64_t nidx = m_node[m] - min_id;
      const uint8_t* np_ = node_pool + node_off[nidx];
      const int64_t nlen = node_off[nidx + 1] - node_off[nidx];
      const bool rev = m_rev[m] != 0;
      int64_t offset = m_offset[m];
      for (int64_t e = e_off[m]; e < e_off[m + 1]; ++e) {
        const int32_t fl = e_from[e], tl = e_to[e];
        const bool has_seq = e_soff[e + 1] > e_soff[e];
        if (fl == tl && !has_seq) {  // match: copy node bases
          for (int64_t k = 0; k < fl; ++k) {
            int64_t pos = offset + k;
            uint8_t c = rev ? comp(np_[nlen - 1 - pos]) : np_[pos];
            rbuf.push_back(c);
          }
        } else {  // sub / insertion: copy edit sequence
          for (int64_t k = e_soff[e]; k < e_soff[e + 1]; ++k)
            rbuf.push_back(char2code(eseq[k]));
        }
        offset += fl;
      }
    }

    // pass 2: graph side + '-' splices into the read at f
    std::vector<uint8_t> rs(rbuf.begin(), rbuf.end());
    int64_t f = 0;
    int64_t n_sizes = 0;
    for (int64_t m = m0; m < m1; ++m) {
      const int64_t nidx = m_node[m] - min_id;
      const uint8_t* np_ = node_pool + node_off[nidx];
      const int64_t nlen = node_off[nidx + 1] - node_off[nidx];
      const bool rev = m_rev[m] != 0;
      int64_t offset = m_offset[m];
      for (int64_t e = e_off[m]; e < e_off[m + 1]; ++e) {
        const int32_t fl = e_from[e], tl = e_to[e];
        const bool has_seq = e_soff[e + 1] > e_soff[e];
        const bool is_ins = fl == 0 && tl > 0;
        const bool is_del = tl == 0 && fl > 0;
        const bool softclip =
            (m == m0) && offset == 0 && is_ins;  // edit_counter frozen 0
        int64_t aligned = 0;
        if ((fl == tl && !has_seq) || (fl == tl && has_seq)) {
          // match or sub: copy node substring
          int64_t take = fl;
          if (offset + take > nlen) take = nlen > offset ? nlen - offset : 0;
          if (gp + take > g_cap) return -(a + 1);
          for (int64_t k = 0; k < take; ++k) {
            int64_t pos = offset + k;
            out_g[gp++] = rev ? comp(np_[nlen - 1 - pos]) : np_[pos];
          }
          aligned = take;
        } else if (is_ins) {
          if (gp + tl > g_cap) return -(a + 1);
          for (int64_t k = 0; k < tl; ++k)
            out_g[gp++] = softclip ? SOFTCLIP : GAP;
          aligned = tl;
        } else if (is_del) {
          int64_t take = fl;
          if (offset + take > nlen) take = nlen > offset ? nlen - offset : 0;
          if (gp + take > g_cap) return -(a + 1);
          for (int64_t k = 0; k < take; ++k) {
            int64_t pos = offset + k;
            out_g[gp++] = rev ? comp(np_[nlen - 1 - pos]) : np_[pos];
          }
          aligned = take;
          // splice '-' * fl into the read at position f
          size_t at = (size_t)(f < (int64_t)rs.size() ? f : rs.size());
          rs.insert(rs.begin() + at, (size_t)fl, GAP);
        } else {
          aligned = 0;  // zero-length edit
        }
        offset += fl;
        f += fl;
        if (sp >= s_cap) return -(a + 1);
        out_sizes[sp++] = (int32_t)aligned;
        n_sizes++;
      }
    }
    out_g_len[a] = gp - g_off[a];
    out_s_len[a] = n_sizes;
    if (r_off[a] + (int64_t)rs.size() > r_cap) return -(a + 1);
    std::memcpy(out_r + r_off[a], rs.data(), rs.size());
    out_r_len[a] = (int64_t)rs.size();
  }
  return 0;
}

}  // extern "C"
