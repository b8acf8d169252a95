// Edge-list parser for graph.txt: host code, no kernel.
//
// The port's counterpart of fora_tpu/_native/graph_io.cpp (173-283,
// fora_count_edges / fora_parse_edges / fora_parse_edges_w), compiled into
// this library so that the port loads nothing of the JAX package;
// graph/io.py::parse_edges_library calls it through ctypes and
// graph/io.py::parse_edges_numpy is the numpy.loadtxt branch it stands in
// for.  One "src dst" (or "src dst weight") line per edge; blank lines and
// lines starting with '#' are skipped.
//
// Two departures from the JAX package's parser, so that the two branches of
// load_dataset give equal arrays:
//   - a weight is read with strtod (correctly rounded, as numpy reads it),
//     not digit by digit;
//   - every data line must have exactly `cols` fields (2, or 3 on a
//     weighted graph): numpy.loadtxt refuses a ragged file, and so does this
//     parser (return -3), where the JAX package's read a missing weight as 1.
//
// It runs once per dataset when a graph is loaded for a CUDA device: at the
// bench's scale (8.4 M edges, about 110 MB of text) numpy.loadtxt takes tens
// of seconds.  The file is read whole into one buffer with a NUL after it,
// so strtoll/strtod never read past its end.
#include <errno.h>
#include <stdint.h>
#include <stdio.h>
#include <stdlib.h>

namespace {

char* read_file(const char* path, long long* size) {
  FILE* f = fopen(path, "rb");
  if (f == nullptr) return nullptr;
  char* buf = nullptr;
  long long n = -1;
  if (fseek(f, 0, SEEK_END) == 0) n = ftell(f);
  if (n >= 0 && fseek(f, 0, SEEK_SET) == 0) {
    buf = static_cast<char*>(malloc((size_t)n + 1));
    if (buf != nullptr && (long long)fread(buf, 1, (size_t)n, f) != n) {
      free(buf);
      buf = nullptr;
    }
  }
  fclose(f);
  if (buf != nullptr) {
    buf[n] = '\0';
    *size = n;
  }
  return buf;
}

inline bool is_space(char c) { return c == ' ' || c == '\t' || c == '\r'; }

}  // namespace

// Parses `path`, `cols` (2 or 3) fields a line.  With src null it only
// counts.  Returns the edge count; -1 if the file cannot be read, -2 if it
// holds more than `cap` edges, -3 on a line that is not `cols` numbers.
extern "C" long long fora_parse_edges(const char* path, int cols, long long* src,
                                      long long* dst, float* w, long long cap) {
  if (cols != 2 && cols != 3) return -3;
  long long size = 0;
  char* buf = read_file(path, &size);
  if (buf == nullptr) return -1;
  const char* p = buf;
  const char* end = buf + size;
  long long count = 0, rc = 0;
  while (p < end) {
    while (p < end && is_space(*p)) ++p;
    if (p < end && (*p == '#' || *p == '\n')) {  // comment or blank line
      while (p < end && *p != '\n') ++p;
      if (p < end) ++p;
      continue;
    }
    if (p >= end) break;
    long long v[2];
    double wt = 1.0;
    int got = 0;
    bool bad = false;
    while (true) {
      while (p < end && is_space(*p)) ++p;
      if (p >= end || *p == '\n') break;
      char* after = nullptr;
      errno = 0;
      if (got < 2) {
        v[got] = strtoll(p, &after, 10);
      } else {
        wt = strtod(p, &after);
      }
      if (after == p || errno != 0 || got >= cols ||
          (after < end && !is_space(*after) && *after != '\n')) {
        bad = true;
        break;
      }
      ++got;
      p = after;
    }
    if (bad || got != cols) {
      rc = -3;
      break;
    }
    if (src != nullptr) {
      if (count >= cap) {
        rc = -2;
        break;
      }
      src[count] = v[0];
      dst[count] = v[1];
      if (w != nullptr) w[count] = (float)wt;
    }
    ++count;
    while (p < end && *p != '\n') ++p;
    if (p < end) ++p;
  }
  free(buf);
  return rc < 0 ? rc : count;
}
