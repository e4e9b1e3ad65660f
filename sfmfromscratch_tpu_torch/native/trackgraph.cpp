// Native match-graph track builder (union-find over keypoint nodes).
//
// The reference links observations into 3-D tracks by scanning the whole map
// per added point — an O(N^2) Python loop (Runner.py:361-385, hot loop 7 in
// SURVEY.md §3.5). For large scenes the right structure is the match graph:
// nodes are (image, keypoint) slots, edges are verified matches, and tracks
// are connected components. Pointer-chasing union-find is exactly the workload
// that belongs in native code next to the TPU compute path (it is branchy,
// irregular, and tiny per element).
//
// Build: g++ -O3 -shared -fPIC trackgraph.cpp -o libsfmtrack.so

#include <cstdint>
#include <cstddef>

extern "C" {

// Path-halving find.
static int64_t uf_find(int64_t* parent, int64_t x) {
    while (parent[x] != x) {
        parent[x] = parent[parent[x]];
        x = parent[x];
    }
    return x;
}

// Build tracks from match edges over n nodes.
//  edges_a/edges_b: (m,) node ids per verified match edge
//  parent: (n,) workspace, overwritten
//  track_out: (n,) resulting 0-based track id per node
// Returns the number of tracks (connected components).
int64_t build_tracks(const int64_t* edges_a, const int64_t* edges_b, int64_t m,
                     int64_t n, int64_t* parent, int64_t* track_out) {
    for (int64_t i = 0; i < n; ++i) parent[i] = i;
    for (int64_t e = 0; e < m; ++e) {
        int64_t ra = uf_find(parent, edges_a[e]);
        int64_t rb = uf_find(parent, edges_b[e]);
        if (ra != rb) parent[rb] = ra;  // union by arrival order
    }
    // Compact component roots to dense track ids.
    int64_t num_tracks = 0;
    for (int64_t i = 0; i < n; ++i) track_out[i] = -1;
    for (int64_t i = 0; i < n; ++i) {
        int64_t r = uf_find(parent, i);
        if (track_out[r] < 0) track_out[r] = num_tracks++;
        track_out[i] = track_out[r];
    }
    return num_tracks;
}

// Filter inconsistent tracks: a track observed twice in the SAME image is
// ambiguous (a standard SfM track-sanity rule). Marks such tracks invalid.
//  node_image: (n,) image id per node
//  track_ids:  (n,) track id per node (from build_tracks)
//  valid_out:  (num_tracks,) 1 if consistent, 0 otherwise
//  scratch:    (num_tracks,) int64 workspace
void filter_duplicate_image_tracks(const int64_t* node_image,
                                   const int64_t* track_ids, int64_t n,
                                   int64_t num_tracks, int64_t* valid_out,
                                   int64_t* scratch) {
    for (int64_t t = 0; t < num_tracks; ++t) { valid_out[t] = 1; scratch[t] = -1; }
    // scratch[t] remembers the last image seen for track t in a sweep ordered
    // by (image): we instead detect duplicates via a two-pass per-image scan.
    // Simple approach: for each node, if another node of the same track and
    // image was already seen, invalidate. We reuse scratch as "last image
    // seen per track"; duplicates within an image hit scratch[t]==image.
    for (int64_t i = 0; i < n; ++i) {
        int64_t t = track_ids[i];
        if (t < 0) continue;
        if (scratch[t] == node_image[i]) valid_out[t] = 0;
        else scratch[t] = node_image[i];
    }
}

}  // extern "C"
