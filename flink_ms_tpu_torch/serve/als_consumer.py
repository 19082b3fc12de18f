"""CLI entry: the ALS serving job (see consumer.py; ALSKafkaConsumer)."""
from .consumer import als_main

if __name__ == "__main__":
    als_main()
