from .ft import HeartbeatMonitor, RemeshPlan, Supervisor, plan_elastic_remesh

__all__ = ["HeartbeatMonitor", "RemeshPlan", "Supervisor",
           "plan_elastic_remesh"]
