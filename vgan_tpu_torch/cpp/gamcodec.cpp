// Copied from vgan_tpu/cpp/gamcodec.cpp (unchanged below this line).
// Native GAM codec: BGZF inflate + vg::Alignment protobuf parse into
// columnar arrays.
//
// This is the framework's native-runtime replacement for the
// reference's libvgio + protobuf stack (`src/readGAM.h:37-51`,
// SURVEY.md §2.8): the hot ingestion path decodes a whole GAM into
// flat arrays the Python/JAX layer wraps zero-copy via ctypes.
//
// Wire format (verified against the reference fixtures, see
// vgan_tpu/io/gam.py): BGZF blocks carrying groups of
//   varint(count) tag("GAM") [count-1 length-prefixed messages]
// Alignment fields: sequence=1 path=2 name=3 quality=4
//   mapping_quality=5 score=6 is_secondary=15 identity=16
//   read_paired=24; Path.mapping=2; Mapping: position=1 edit=2 rank=5;
//   Position: node_id=1 offset=2 is_reverse=4;
//   Edit: from_length=1 to_length=2 sequence=3.
//
// Build: make -C vgan_tpu/cpp  (produces libgamcodec.so)

#include <cstdint>
#include <cstring>
#include <string>
#include <vector>
#include <zlib.h>

namespace {

struct Buf {
  const uint8_t* p;
  size_t n;
  size_t off = 0;
  bool ok = true;

  uint64_t varint() {
    uint64_t v = 0;
    int shift = 0;
    while (off < n) {
      uint8_t b = p[off++];
      v |= uint64_t(b & 0x7f) << shift;
      if (!(b & 0x80)) return v;
      shift += 7;
    }
    ok = false;
    return 0;
  }
};

struct Columns {
  // per alignment
  std::vector<int64_t> seq_off{0}, name_off{0}, qual_off{0};
  std::string seqs, names, quals;
  std::vector<int32_t> mapq, score;
  std::vector<double> identity;
  std::vector<uint8_t> paired;
  std::vector<int64_t> map_start{0};  // per-read mapping CSR
  // per mapping
  std::vector<int64_t> node_id;
  std::vector<int32_t> node_off;
  std::vector<uint8_t> is_rev;
  std::vector<int32_t> rank;
  std::vector<int64_t> edit_start{0};  // per-mapping edit CSR
  // per edit
  std::vector<int32_t> from_len, to_len;
  std::vector<int64_t> eseq_off{0};
  std::string eseqs;
};

void parse_position(const uint8_t* d, size_t len, int64_t* nid, int32_t* noff,
                    uint8_t* rev) {
  Buf b{d, len};
  *nid = 0; *noff = 0; *rev = 0;
  while (b.off < b.n && b.ok) {
    uint64_t key = b.varint();
    uint32_t fn = key >> 3, wt = key & 7;
    if (wt == 0) {
      uint64_t v = b.varint();
      if (fn == 1) *nid = (int64_t)v;
      else if (fn == 2) *noff = (int32_t)v;
      else if (fn == 4) *rev = v ? 1 : 0;
    } else if (wt == 2) {
      uint64_t l = b.varint();
      b.off += l;
    } else if (wt == 1) b.off += 8;
    else if (wt == 5) b.off += 4;
    else { b.ok = false; }
  }
}

void parse_edit(const uint8_t* d, size_t len, Columns& c) {
  Buf b{d, len};
  int32_t fl = 0, tl = 0;
  std::string seq;
  while (b.off < b.n && b.ok) {
    uint64_t key = b.varint();
    uint32_t fn = key >> 3, wt = key & 7;
    if (wt == 0) {
      uint64_t v = b.varint();
      if (fn == 1) fl = (int32_t)v;
      else if (fn == 2) tl = (int32_t)v;
    } else if (wt == 2) {
      uint64_t l = b.varint();
      if (fn == 3) seq.assign((const char*)b.p + b.off, l);
      b.off += l;
    } else if (wt == 1) b.off += 8;
    else if (wt == 5) b.off += 4;
    else { b.ok = false; }
  }
  c.from_len.push_back(fl);
  c.to_len.push_back(tl);
  c.eseqs += seq;
  c.eseq_off.push_back((int64_t)c.eseqs.size());
}

void parse_mapping(const uint8_t* d, size_t len, Columns& c) {
  Buf b{d, len};
  int64_t nid = 0;
  int32_t noff = 0, rk = 0;
  uint8_t rev = 0;
  while (b.off < b.n && b.ok) {
    uint64_t key = b.varint();
    uint32_t fn = key >> 3, wt = key & 7;
    if (wt == 0) {
      uint64_t v = b.varint();
      if (fn == 5) rk = (int32_t)v;
    } else if (wt == 2) {
      uint64_t l = b.varint();
      if (fn == 1) parse_position(b.p + b.off, l, &nid, &noff, &rev);
      else if (fn == 2) parse_edit(b.p + b.off, l, c);
      b.off += l;
    } else if (wt == 1) b.off += 8;
    else if (wt == 5) b.off += 4;
    else { b.ok = false; }
  }
  c.node_id.push_back(nid);
  c.node_off.push_back(noff);
  c.is_rev.push_back(rev);
  c.rank.push_back(rk);
  c.edit_start.push_back((int64_t)c.from_len.size());
}

void parse_path(const uint8_t* d, size_t len, Columns& c) {
  Buf b{d, len};
  while (b.off < b.n && b.ok) {
    uint64_t key = b.varint();
    uint32_t fn = key >> 3, wt = key & 7;
    if (wt == 0) b.varint();
    else if (wt == 2) {
      uint64_t l = b.varint();
      if (fn == 2) parse_mapping(b.p + b.off, l, c);
      b.off += l;
    } else if (wt == 1) b.off += 8;
    else if (wt == 5) b.off += 4;
    else { b.ok = false; }
  }
}

void parse_alignment(const uint8_t* d, size_t len, Columns& c) {
  Buf b{d, len};
  int32_t mq = 0, sc = 0;
  double ident = 0.0;
  uint8_t paired = 0;
  while (b.off < b.n && b.ok) {
    uint64_t key = b.varint();
    uint32_t fn = key >> 3, wt = key & 7;
    if (wt == 0) {
      uint64_t v = b.varint();
      if (fn == 5) mq = (int32_t)v;
      else if (fn == 6) sc = (int32_t)v;
      else if (fn == 24) paired = v ? 1 : 0;
    } else if (wt == 2) {
      uint64_t l = b.varint();
      const char* s = (const char*)b.p + b.off;
      if (fn == 1) c.seqs.append(s, l);
      else if (fn == 2) parse_path(b.p + b.off, l, c);
      else if (fn == 3) c.names.append(s, l);
      else if (fn == 4) c.quals.append(s, l);
      b.off += l;
    } else if (wt == 1) {
      if (fn == 16) std::memcpy(&ident, b.p + b.off, 8);
      b.off += 8;
    } else if (wt == 5) b.off += 4;
    else { b.ok = false; }
  }
  c.seq_off.push_back((int64_t)c.seqs.size());
  c.name_off.push_back((int64_t)c.names.size());
  c.qual_off.push_back((int64_t)c.quals.size());
  c.mapq.push_back(mq);
  c.score.push_back(sc);
  c.identity.push_back(ident);
  c.paired.push_back(paired);
  c.map_start.push_back((int64_t)c.node_id.size());
}

bool inflate_all(const uint8_t* data, size_t len, std::string& out) {
  // BGZF = concatenated gzip members; inflate them all
  z_stream zs{};
  size_t off = 0;
  out.clear();
  out.reserve(len * 4);
  char buf[1 << 16];
  while (off < len) {
    std::memset(&zs, 0, sizeof(zs));
    if (inflateInit2(&zs, 15 + 32) != Z_OK) return false;
    zs.next_in = (Bytef*)(data + off);
    zs.avail_in = (uInt)(len - off);
    int ret = Z_OK;
    while (ret != Z_STREAM_END) {
      zs.next_out = (Bytef*)buf;
      zs.avail_out = sizeof(buf);
      ret = inflate(&zs, Z_NO_FLUSH);
      if (ret != Z_OK && ret != Z_STREAM_END) {
        inflateEnd(&zs);
        return false;
      }
      out.append(buf, sizeof(buf) - zs.avail_out);
    }
    off = len - zs.avail_in;
    inflateEnd(&zs);
  }
  return true;
}

}  // namespace

extern "C" {

struct GamHandle {
  Columns c;
  std::string decompressed;
  int64_t n_reads = 0;
};

GamHandle* gam_parse(const uint8_t* data, int64_t len) {
  auto* h = new GamHandle();
  const uint8_t* payload = data;
  size_t payload_len = (size_t)len;
  if (len >= 2 && data[0] == 0x1f && data[1] == 0x8b) {
    if (!inflate_all(data, (size_t)len, h->decompressed)) {
      delete h;
      return nullptr;
    }
    payload = (const uint8_t*)h->decompressed.data();
    payload_len = h->decompressed.size();
  }
  Buf b{payload, payload_len};
  while (b.off < b.n && b.ok) {
    uint64_t count = b.varint();
    if (!b.ok) break;
    uint64_t tlen = b.varint();
    if (b.off + tlen > b.n) break;
    b.off += tlen;  // tag string ("GAM")
    for (uint64_t i = 0; i + 1 < count && b.ok; ++i) {
      uint64_t mlen = b.varint();
      if (b.off + mlen > b.n) { b.ok = false; break; }
      parse_alignment(b.p + b.off, mlen, h->c);
      b.off += mlen;
      h->n_reads++;
    }
  }
  return h;
}

void gam_free(GamHandle* h) { delete h; }

int64_t gam_n_reads(GamHandle* h) { return h->n_reads; }
int64_t gam_n_mappings(GamHandle* h) { return (int64_t)h->c.node_id.size(); }
int64_t gam_n_edits(GamHandle* h) { return (int64_t)h->c.from_len.size(); }
int64_t gam_seqs_len(GamHandle* h) { return (int64_t)h->c.seqs.size(); }
int64_t gam_names_len(GamHandle* h) { return (int64_t)h->c.names.size(); }
int64_t gam_quals_len(GamHandle* h) { return (int64_t)h->c.quals.size(); }
int64_t gam_eseqs_len(GamHandle* h) { return (int64_t)h->c.eseqs.size(); }

const char* gam_seqs(GamHandle* h) { return h->c.seqs.data(); }
const char* gam_names(GamHandle* h) { return h->c.names.data(); }
const char* gam_quals(GamHandle* h) { return h->c.quals.data(); }
const char* gam_eseqs(GamHandle* h) { return h->c.eseqs.data(); }
const int64_t* gam_seq_off(GamHandle* h) { return h->c.seq_off.data(); }
const int64_t* gam_name_off(GamHandle* h) { return h->c.name_off.data(); }
const int64_t* gam_qual_off(GamHandle* h) { return h->c.qual_off.data(); }
const int64_t* gam_eseq_off(GamHandle* h) { return h->c.eseq_off.data(); }
const int32_t* gam_mapq(GamHandle* h) { return h->c.mapq.data(); }
const int32_t* gam_score(GamHandle* h) { return h->c.score.data(); }
const double* gam_identity(GamHandle* h) { return h->c.identity.data(); }
const uint8_t* gam_paired(GamHandle* h) { return h->c.paired.data(); }
const int64_t* gam_map_start(GamHandle* h) { return h->c.map_start.data(); }
const int64_t* gam_node_id(GamHandle* h) { return h->c.node_id.data(); }
const int32_t* gam_node_off(GamHandle* h) { return h->c.node_off.data(); }
const uint8_t* gam_is_rev(GamHandle* h) { return h->c.is_rev.data(); }
const int32_t* gam_rank(GamHandle* h) { return h->c.rank.data(); }
const int64_t* gam_edit_start(GamHandle* h) { return h->c.edit_start.data(); }
const int32_t* gam_from_len(GamHandle* h) { return h->c.from_len.data(); }
const int32_t* gam_to_len(GamHandle* h) { return h->c.to_len.data(); }

}  // extern "C"
