"""The paper's math: participation traces, arrivals, departures,
aggregation schemes and the masked local-SGD round."""
