// Host input: one chunk read and parsed a piece at a time, in one call.
//
// Built by io/native.py into one library with native/kmc_host.cpp, whose
// parsers and gzip reader it calls.  The reader pool calls it once a chunk
// from Python with the interpreter lock released, so its threads no longer
// take the lock back between the read and the parse of every piece.
#include <cerrno>
#include <cstdint>
#include <ctime>
#include <unistd.h>

extern "C" {

int64_t parse_fastq(const uint8_t* buf, int64_t n, uint8_t* out,
                    int64_t* state);
int64_t parse_fasta(const uint8_t* buf, int64_t n, uint8_t* out,
                    int64_t* state);
int64_t gz_read(void* handle, uint8_t* out, int64_t out_cap);

// Fills buf[0, n) from a reader the library does not know; returns the
// bytes written (fewer only at end of input), or < 0 on an error.
typedef int64_t (*fill_fn)(uint8_t* buf, int64_t n);

static int64_t now_ns() {
    timespec t;
    clock_gettime(CLOCK_MONOTONIC, &t);
    return (int64_t)t.tv_sec * 1000000000 + t.tv_nsec;
}

// Reads at most `want` input bytes into buf in pieces of at most `piece`
// bytes and parses each piece as soon as it is read, its codes written at
// the running offset of out (which holds at least `want`: the parsers
// write at most a code a byte).  Every source fills the piece it is given
// except at end of input, so the chunk ends at the byte one read of `want`
// would end it.  The source: the file descriptor fd when fd >= 0 (read(2)
// from its offset), else the gzip reader gz when not null, else fill.
// io[0]: input bytes read; io[1]: the last of them (10 when none);
// io[2]: pieces; io[3]: nanoseconds spent reading.  Returns the codes
// written, or -1 when the source fails (errno holds read(2)'s error).
int64_t read_parse_chunk(int fd, void* gz, fill_fn fill, int fasta,
                         uint8_t* buf, int64_t piece, int64_t want,
                         uint8_t* out, int64_t* state, int64_t* io) {
    int64_t n = 0, m = 0, pieces = 0, read_ns = 0;
    int64_t last = 10;
    while (n < want) {
        int64_t ask = want - n < piece ? want - n : piece;
        int64_t t0 = now_ns();
        int64_t got;
        if (fd >= 0) {
            got = (int64_t)read(fd, buf, (size_t)ask);
            if (got < 0 && errno == EINTR) continue;
        } else if (gz) {
            got = gz_read(gz, buf, ask);
        } else {
            got = fill(buf, ask);
        }
        read_ns += now_ns() - t0;
        if (got < 0) return -1;
        if (got == 0) break;
        m += fasta ? parse_fasta(buf, got, out + m, state)
                   : parse_fastq(buf, got, out + m, state);
        last = buf[got - 1];
        n += got;
        pieces++;
    }
    io[0] = n;
    io[1] = last;
    io[2] = pieces;
    io[3] = read_ns;
    return m;
}

}  // extern "C"
