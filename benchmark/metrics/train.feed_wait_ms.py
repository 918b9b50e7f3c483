"""Time a step waited for its batch from the feeder's queue (the shard
reader, the curriculum and the copy to the card), in ms per step."""


def read(run):
    return run.readings.get("feed_wait_ms")
