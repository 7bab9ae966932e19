def read(r):
    """Host ms a batch from the neck's forward returning on the host to
    the detections on the host, over the untraced stretch: the head,
    decode, top-k, the NMS with its syncs, the resolve and the copy, and
    the wait for device work queued before them."""
    times = r.extra.get("after_neck_s")
    return 1e3 * sum(times) / len(times) if times else None
