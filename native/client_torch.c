/* fqz5-torch: millisecond CLI client for the PyTorch port's daemon.
 *
 * Speaks fqzcomp5_tpu_torch/daemon.py's protocol directly: one JSON
 * request line {"argv": [...], "cwd": "...", "umask": N, "env": {...}}
 * sent with fds 0/1/2 over SCM_RIGHTS, and one JSON reply line,
 * {"rc": N} or {"stale": true}.  A Python client pays the interpreter's
 * start-up on every call; this one costs about a millisecond plus the
 * daemon's round trip.
 *
 * Socket: FQZ5_DAEMON=<path> when set to anything but 0, 1 or auto,
 * else $TMPDIR/fqz5-torch-daemon-$UID.sock (daemon.default_socket_path;
 * never the JAX package's daemon).  Forwarded: FQZ5_* but FQZ5_DAEMON,
 * TMPDIR and CUDA_VISIBLE_DEVICES (daemon._FORWARDED).
 *
 * Before the request is delivered, anything the daemon cannot serve
 * falls back to `python3 -m fqzcomp5_tpu_torch.launcher ARGS` with the
 * repository root first on PYTHONPATH: no daemon answers, connect or
 * sendmsg fails, FQZ5_NO_DAEMON is set, FQZ5_DAEMON=0, a control verb
 * (--daemon, --daemon-stop), or a {"stale": true} reply (the job did
 * not run).  The launcher runs the job and starts a daemon for the next
 * call.  Once sendmsg has succeeded the job may have run, so a lost
 * reply is a failure (ERROR: on stderr, exit LOST_RC = 1), never a
 * second run.
 *
 * No signal handling: when the client dies (Ctrl-C, SIGKILL) its socket
 * closes, and the daemon kills the job.
 *
 * Built by bin/fqz5-torch into build/fqz5_torch_client/fqz5-torch; the
 * repository root is three levels above the binary (/proc/self/exe).
 */
#define _GNU_SOURCE
#include <errno.h>
#include <limits.h>
#include <stdio.h>
#include <stdlib.h>
#include <string.h>
#include <sys/socket.h>
#include <sys/stat.h>
#include <sys/types.h>
#include <sys/un.h>
#include <unistd.h>

#define LOST_RC 1

extern char **environ;

/* ---- growable byte buffer -------------------------------------- */
typedef struct { char *p; size_t n, cap; } buf_t;

static void buf_put(buf_t *b, const char *s, size_t n) {
    if (b->n + n + 1 > b->cap) {
        size_t cap = b->cap ? b->cap : 4096;
        while (cap < b->n + n + 1) cap *= 2;
        char *p = realloc(b->p, cap);
        if (!p) { fputs("ERROR: fqz5-torch: out of memory\n", stderr); _exit(1); }
        b->p = p;
        b->cap = cap;
    }
    memcpy(b->p + b->n, s, n);
    b->n += n;
    b->p[b->n] = 0;
}

static void buf_str(buf_t *b, const char *s) { buf_put(b, s, strlen(s)); }

/* Length of the valid UTF-8 sequence at s (strict, as Python decodes:
 * no overlongs, no surrogates, nothing past U+10FFFF), or 0. */
static int utf8_len(const unsigned char *s) {
    unsigned c = s[0];
    if (c < 0x80) return 1;
    if (c >= 0xC2 && c <= 0xDF)
        return (s[1] & 0xC0) == 0x80 ? 2 : 0;
    if (c >= 0xE0 && c <= 0xEF) {
        unsigned lo = c == 0xE0 ? 0xA0 : 0x80, hi = c == 0xED ? 0x9F : 0xBF;
        return (s[1] >= lo && s[1] <= hi && (s[2] & 0xC0) == 0x80) ? 3 : 0;
    }
    if (c >= 0xF0 && c <= 0xF4) {
        unsigned lo = c == 0xF0 ? 0x90 : 0x80, hi = c == 0xF4 ? 0x8F : 0xBF;
        return (s[1] >= lo && s[1] <= hi && (s[2] & 0xC0) == 0x80 &&
                (s[3] & 0xC0) == 0x80) ? 4 : 0;
    }
    return 0;
}

/* JSON string literal.  Bytes that are not UTF-8 become \udcXX, the
 * surrogate escapes Python's os.fsdecode makes of them, so a file name
 * reaches the job as a direct run would see it. */
static void buf_json(buf_t *b, const char *str) {
    const unsigned char *c = (const unsigned char *)str;
    char e[8];
    buf_put(b, "\"", 1);
    while (*c) {
        int n = utf8_len(c);
        if (*c == '"' || *c == '\\') {
            e[0] = '\\';
            e[1] = (char)*c;
            buf_put(b, e, 2);
        } else if (*c < 0x20) {
            snprintf(e, sizeof e, "\\u%04x", *c);
            buf_put(b, e, 6);
        } else if (n == 0) {
            snprintf(e, sizeof e, "\\udc%02x", *c);
            buf_put(b, e, 6);
            n = 1;
        } else {
            buf_put(b, (const char *)c, (size_t)n);
        }
        c += n ? n : 1;
    }
    buf_put(b, "\"", 1);
}

static int forwarded(const char *kv, size_t kl) {
    if (kl >= 5 && !strncmp(kv, "FQZ5_", 5))
        return !(kl == 11 && !strncmp(kv, "FQZ5_DAEMON", 11));
    return (kl == 6 && !strncmp(kv, "TMPDIR", 6)) ||
           (kl == 20 && !strncmp(kv, "CUDA_VISIBLE_DEVICES", 20));
}

/* ---- the Python launcher --------------------------------------- */
static void fallback(char **argv) {
    char root[PATH_MAX];
    ssize_t n = readlink("/proc/self/exe", root, sizeof root - 1);
    if (n <= 0) { perror("ERROR: fqz5-torch: readlink /proc/self/exe"); _exit(1); }
    root[n] = 0;
    for (int up = 0; up < 3; up++) {   /* ROOT/build/fqz5_torch_client/exe */
        char *slash = strrchr(root, '/');
        if (!slash) { fputs("ERROR: fqz5-torch: no repository root\n", stderr); _exit(1); }
        *slash = 0;
    }
    const char *pp = getenv("PYTHONPATH");
    buf_t path = {0};
    buf_str(&path, root);
    if (pp && *pp) {
        buf_str(&path, ":");
        buf_str(&path, pp);
    }
    setenv("PYTHONPATH", path.p, 1);
    int nargs = 0;
    while (argv[nargs]) nargs++;
    char **nv = calloc((size_t)nargs + 4, sizeof(char *));
    if (!nv) { fputs("ERROR: fqz5-torch: out of memory\n", stderr); _exit(1); }
    nv[0] = "python3";
    nv[1] = "-m";
    nv[2] = "fqzcomp5_tpu_torch.launcher";
    for (int i = 1; i < nargs; i++) nv[i + 2] = argv[i];
    execvp("python3", nv);
    perror("ERROR: fqz5-torch: exec python3");
    _exit(1);
}

static void lost(const char *path, const char *why) {
    fprintf(stderr, "ERROR: the fqz5 daemon on %s took the request and gave "
            "no reply (%s); the job may have run\n", path, why);
    exit(LOST_RC);
}

int main(int argc, char **argv) {
    const char *dmn = getenv("FQZ5_DAEMON");
    const char *nod = getenv("FQZ5_NO_DAEMON");
    if ((nod && *nod) || (dmn && !strcmp(dmn, "0")))
        fallback(argv);
    for (int i = 1; i < argc; i++)
        if (!strcmp(argv[i], "--daemon") || !strcmp(argv[i], "--daemon-stop"))
            fallback(argv);

    char sock_path[PATH_MAX];
    if (dmn && *dmn && strcmp(dmn, "1") && strcmp(dmn, "auto")) {
        snprintf(sock_path, sizeof sock_path, "%s", dmn);
    } else {
        const char *tmp = getenv("TMPDIR");
        snprintf(sock_path, sizeof sock_path, "%s/fqz5-torch-daemon-%ld.sock",
                 (tmp && *tmp) ? tmp : "/tmp", (long)getuid());
    }
    struct sockaddr_un sa;
    memset(&sa, 0, sizeof sa);
    sa.sun_family = AF_UNIX;
    if (strlen(sock_path) >= sizeof sa.sun_path) fallback(argv);
    strcpy(sa.sun_path, sock_path);
    char cwd[PATH_MAX];
    if (!getcwd(cwd, sizeof cwd)) fallback(argv);

    int fd = socket(AF_UNIX, SOCK_STREAM | SOCK_CLOEXEC, 0);
    if (fd < 0) fallback(argv);
    if (connect(fd, (struct sockaddr *)&sa, sizeof sa) != 0) {
        close(fd);
        fallback(argv);
    }

    buf_t b = {0};
    buf_str(&b, "{\"argv\": [");
    for (int i = 1; i < argc; i++) {
        if (i > 1) buf_str(&b, ", ");
        buf_json(&b, argv[i]);
    }
    buf_str(&b, "], \"cwd\": ");
    buf_json(&b, cwd);
    mode_t um = umask(0);
    umask(um);
    char num[48];
    snprintf(num, sizeof num, ", \"umask\": %d, \"env\": {", (int)um);
    buf_str(&b, num);
    int first = 1;
    for (char **e = environ; *e; e++) {
        const char *eq = strchr(*e, '=');
        if (!eq || !forwarded(*e, (size_t)(eq - *e))) continue;
        char key[256];
        size_t kl = (size_t)(eq - *e);
        if (kl >= sizeof key) continue;
        memcpy(key, *e, kl);
        key[kl] = 0;
        if (!first) buf_str(&b, ", ");
        first = 0;
        buf_json(&b, key);
        buf_str(&b, ": ");
        buf_json(&b, eq + 1);
    }
    buf_str(&b, "}}\n");

    /* the request line with fds 0, 1, 2; the first sendmsg carries the
     * fds, and a short write is finished with send */
    struct iovec iov = {b.p, b.n};
    char cbuf[CMSG_SPACE(3 * sizeof(int))];
    memset(cbuf, 0, sizeof cbuf);
    struct msghdr mh;
    memset(&mh, 0, sizeof mh);
    mh.msg_iov = &iov;
    mh.msg_iovlen = 1;
    mh.msg_control = cbuf;
    mh.msg_controllen = sizeof cbuf;
    struct cmsghdr *cm = CMSG_FIRSTHDR(&mh);
    cm->cmsg_level = SOL_SOCKET;
    cm->cmsg_type = SCM_RIGHTS;
    cm->cmsg_len = CMSG_LEN(3 * sizeof(int));
    int fds[3] = {0, 1, 2};
    memcpy(CMSG_DATA(cm), fds, sizeof fds);
    ssize_t sent;
    do sent = sendmsg(fd, &mh, MSG_NOSIGNAL);
    while (sent < 0 && errno == EINTR);
    /* not delivered: a request cut short is dropped by the daemon
     * unread, so the job has not run */
    if (sent < 0) {
        close(fd);
        fallback(argv);
    }
    for (size_t off = (size_t)sent; off < b.n;) {
        ssize_t r = send(fd, b.p + off, b.n - off, MSG_NOSIGNAL);
        if (r < 0 && errno == EINTR) continue;
        if (r <= 0) {
            close(fd);
            fallback(argv);
        }
        off += (size_t)r;
    }

    char rep[512];
    size_t rn = 0;
    while (rn < sizeof rep - 1 && !memchr(rep, '\n', rn)) {
        ssize_t r = read(fd, rep + rn, sizeof rep - 1 - rn);
        if (r < 0 && errno == EINTR) continue;
        if (r < 0) lost(sock_path, strerror(errno));
        if (r == 0) lost(sock_path, "connection closed");
        rn += (size_t)r;
    }
    close(fd);
    rep[rn] = 0;
    if (!memchr(rep, '\n', rn)) lost(sock_path, "reply too long");
    if (strstr(rep, "\"stale\": true"))
        fallback(argv);   /* the daemon retired without running the job */
    const char *rc_s = strstr(rep, "\"rc\":");
    if (!rc_s) lost(sock_path, "no exit code in the reply");
    return (int)(strtol(rc_s + 5, NULL, 10) & 0xFF);
}
