"""msg_ratio (ratio, layer "channels"): the messages the paper's channels
send over Pregel's basic messages, summed over the window's jobs from
``RunResult.stats``: ``msgs_rr / msgs_basic`` for request-respond jobs,
``msgs_total / msgs_basic`` for broadcast jobs; moves evps."""


def read(run):
    sent = basic = 0
    for j in run.jobs:
        key = "msgs_rr" if "msgs_rr" in j.stats else "msgs_total"
        if key not in j.stats or "msgs_basic" not in j.stats:
            return None
        sent += j.stats[key]
        basic += j.stats["msgs_basic"]
    return sent / basic if basic else None
