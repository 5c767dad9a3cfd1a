"""helloworld: a 3-replica in-memory KV on one machine.

reference: lni/dragonboat-example example/helloworld [U] — the minimum
end-to-end slice (BASELINE config 1): three NodeHosts in one process on
the in-proc transport, one raft shard, linearizable writes and reads.

Run:  python examples/helloworld.py
"""
import pickle
import sys
import time

sys.path.insert(0, ".")

from dragonboat_tpu_torch import (
    Config,
    IStateMachine,
    NodeHost,
    NodeHostConfig,
    Result,
)


class KVStore(IStateMachine):
    """Commands are pickled (op, key, value); lookup returns the value."""

    def __init__(self, shard_id, replica_id):
        self.data = {}

    def update(self, entry):
        op, key, value = pickle.loads(entry.cmd)
        if op == "set":
            self.data[key] = value
        elif op == "del":
            self.data.pop(key, None)
        return Result(value=len(self.data))

    def lookup(self, query):
        return self.data.get(query)

    def save_snapshot(self, w, files, done):
        w.write(pickle.dumps(self.data))

    def recover_from_snapshot(self, r, files, done):
        self.data = pickle.loads(r.read())


def main():
    members = {1: "hw-1", 2: "hw-2", 3: "hw-3"}
    hosts = {}
    for replica_id, addr in members.items():
        cfg = NodeHostConfig(
            nodehost_dir=f"/tmp/helloworld-{replica_id}",
            rtt_millisecond=5,
            raft_address=addr,
        )
        hosts[replica_id] = NodeHost(cfg)
    for replica_id, nh in hosts.items():
        nh.start_replica(
            members,
            False,
            KVStore,
            Config(shard_id=128, replica_id=replica_id, election_rtt=10),
        )

    # wait for a leader
    while True:
        leader, ok = hosts[1].get_leader_id(128)
        if ok:
            print(f"leader elected: replica {leader}")
            break
        time.sleep(0.05)

    nh = hosts[2]  # any replica can take proposals (forwarded to the leader)
    session = nh.get_noop_session(128)
    for i in range(10):
        nh.sync_propose(session, pickle.dumps(("set", f"key-{i}", f"v{i}")))
    print("proposed 10 keys")

    # linearizable read from a different replica
    value = hosts[3].sync_read(128, "key-9")
    print(f"sync_read(key-9) from replica 3 -> {value!r}")

    for nh in hosts.values():
        nh.close()
    print("done")


if __name__ == "__main__":
    import shutil

    for rid in (1, 2, 3):
        shutil.rmtree(f"/tmp/helloworld-{rid}", ignore_errors=True)
    main()
