"""CLI entry: the SVM serving job (see consumer.py; SVMKafkaConsumer)."""
from .consumer import svm_main

if __name__ == "__main__":
    svm_main()
