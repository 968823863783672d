// Copied from vgan_tpu/cpp/fastqreader.cpp (unchanged below this line).
// Native FASTQ reader: plain or gzip, columnar output.
//
// Replaces the per-char Python parse in io/fastx.iter_fastq for the
// production data-loading path (the reference links htslib for this,
// src/Makefile:43; here a single zlib-backed parser feeds columnar
// pools that Python slices per read). Qualities are returned already
// phred-decoded (c - 33, floored at 0).
#include <cstdint>
#include <cstring>
#include <string>
#include <vector>
#include <zlib.h>

namespace {

struct FastqData {
  std::vector<char> name_pool;
  std::vector<char> seq_pool;
  std::vector<uint8_t> qual_pool;  // phred values (already -33)
  std::vector<int64_t> name_off;   // n+1
  std::vector<int64_t> seq_off;    // n+1 (quals share seq offsets)
  int64_t n = 0;
};

// read the whole (possibly gzipped) file into a buffer
bool slurp(const char* path, std::vector<char>& out) {
  gzFile f = gzopen(path, "rb");
  if (!f) return false;
  char buf[1 << 16];
  int got;
  while ((got = gzread(f, buf, sizeof buf)) > 0) {
    out.insert(out.end(), buf, buf + got);
  }
  bool ok = got == 0;
  gzclose(f);
  return ok;
}

}  // namespace

extern "C" {

void* fastq_parse(const char* path) {
  std::vector<char> data;
  if (!slurp(path, data)) return nullptr;
  auto* fd = new FastqData();
  fd->name_off.push_back(0);
  fd->seq_off.push_back(0);
  size_t i = 0, n = data.size();
  auto line_end = [&](size_t from) {
    if (from >= n) return n;  // truncated record: no trailing newline
    const char* p =
        static_cast<const char*>(memchr(data.data() + from, '\n', n - from));
    return p ? static_cast<size_t>(p - data.data()) : n;
  };
  while (i < n) {
    // header: '@' name [whitespace desc]
    size_t e = line_end(i);
    if (e > i && data[i] == '@') {
      size_t ns = i + 1, ne = ns;
      while (ne < e && data[ne] != ' ' && data[ne] != '\t' &&
             data[ne] != '\r')
        ++ne;
      fd->name_pool.insert(fd->name_pool.end(), data.data() + ns,
                           data.data() + ne);
    }
    fd->name_off.push_back((int64_t)fd->name_pool.size());
    i = e + 1;
    if (i >= n) { fd->name_off.pop_back(); break; }
    // sequence
    e = line_end(i);
    size_t se = e;
    while (se > i && (data[se - 1] == '\r')) --se;
    fd->seq_pool.insert(fd->seq_pool.end(), data.data() + i,
                        data.data() + se);
    size_t slen = se - i;
    fd->seq_off.push_back((int64_t)fd->seq_pool.size());
    i = e + 1;
    if (i > n) i = n;  // file truncated after sequence line
    // '+' separator
    e = line_end(i);
    i = e + 1;
    if (i > n) i = n;  // file truncated after '+' line
    // qualities
    e = line_end(i);
    size_t qe = e;
    while (qe > i && (data[qe - 1] == '\r')) --qe;
    size_t qlen = qe - i;
    for (size_t j = 0; j < slen; ++j) {
      int q = j < qlen ? (int)(unsigned char)data[i + j] - 33 : 0;
      fd->qual_pool.push_back((uint8_t)(q < 0 ? 0 : q));
    }
    i = e + 1;
    fd->n++;
  }
  return fd;
}

int64_t fastq_n(void* h) { return static_cast<FastqData*>(h)->n; }
int64_t fastq_name_pool_size(void* h) {
  return (int64_t)static_cast<FastqData*>(h)->name_pool.size();
}
int64_t fastq_seq_pool_size(void* h) {
  return (int64_t)static_cast<FastqData*>(h)->seq_pool.size();
}
void fastq_copy(void* h, char* name_pool, int64_t* name_off,
                char* seq_pool, uint8_t* qual_pool, int64_t* seq_off) {
  auto* fd = static_cast<FastqData*>(h);
  memcpy(name_pool, fd->name_pool.data(), fd->name_pool.size());
  memcpy(name_off, fd->name_off.data(),
         fd->name_off.size() * sizeof(int64_t));
  memcpy(seq_pool, fd->seq_pool.data(), fd->seq_pool.size());
  memcpy(qual_pool, fd->qual_pool.data(), fd->qual_pool.size());
  memcpy(seq_off, fd->seq_off.data(),
         fd->seq_off.size() * sizeof(int64_t));
}
void fastq_free(void* h) { delete static_cast<FastqData*>(h); }

}  // extern "C"
